"""Tracker runtime: per-sequence tracking from raw frames."""
