"""Checkpoints and training logs."""
