"""Evaluation helpers (the training pipeline is not ported yet)."""
