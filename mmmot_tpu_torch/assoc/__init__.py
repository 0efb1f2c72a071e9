"""Association: the tracking ILP as a square assignment problem, solved
by the batched integer auction."""
