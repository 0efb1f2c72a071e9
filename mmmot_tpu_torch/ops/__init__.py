"""Masked primitives and on-device preprocessing (crops, frustum points)."""
