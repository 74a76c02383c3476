"""Core PowerWalk algorithms: graph, frontiers, walks, index, VERD, queries."""
