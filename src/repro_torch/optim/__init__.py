"""Optimizers of the threshold fine-tune."""
