"""Numpy parts of the analytics (oracles, edge-weight transforms); the
program factories arrive with the Gopher registry."""
from repro_torch.core.algorithms import pagerank, sssp

__all__ = ["pagerank", "sssp"]
