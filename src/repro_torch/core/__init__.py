"""Core of the port: graph, MFG, sampler, partition, dist, placement."""
