"""The benchmark's shared parts: the cell's files, traffic, weights, yardstick, trace."""
