"""Model definitions over plain parameter trees (nested dicts of tensors in
the JAX package's layout; tests bridge that package's trees with bridge.py)."""
