"""Synthetic graph generators, the neighbour samplers and the partitioner."""
