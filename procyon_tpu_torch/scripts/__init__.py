"""Command-line entry points of procyon_tpu_torch."""
