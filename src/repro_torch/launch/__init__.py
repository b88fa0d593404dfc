"""Serving steps and the Engine facade."""
