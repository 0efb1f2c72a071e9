"""Logging helpers of the trainer."""
