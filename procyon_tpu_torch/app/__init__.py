"""HTTP serving of the retrieval model (main.py, server.py)."""
