"""Atomic, keep-N checkpoints of tensor trees."""
