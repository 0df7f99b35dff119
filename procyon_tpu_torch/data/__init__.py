"""Data layer: the ESM protein tokenizer (numpy)."""
