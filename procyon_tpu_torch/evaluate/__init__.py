"""Evaluation helpers ported so far: the QA readout (qa.py)."""
