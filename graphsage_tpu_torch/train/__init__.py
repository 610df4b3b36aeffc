"""Flags, F1 metrics and torch checkpoints (the trainers come with the
training slice)."""
