"""Flags, F1 metrics, torch checkpoints and the supervised and
unsupervised trainers."""
