"""Inference helpers: cosine top-k retrieval ranking."""
