"""The tracking network, eval forward only."""
