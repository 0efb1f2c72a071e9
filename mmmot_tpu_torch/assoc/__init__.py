"""Association: the tracking ILP as a square assignment problem, solved
on the device by the batched integer auction, Sinkhorn or greedy
matching, or on the host by the exact oracles."""
