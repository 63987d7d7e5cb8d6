"""The analytics' numpy parts: host iBSP Computes and ``run_host``
(sssp, pagerank, nhop, tracking), oracles and edge-weight transforms.
The Gopher registry entries arrive with the session (ROADMAP queue 1,
item 3)."""
from repro_torch.core.algorithms import components, nhop, pagerank, sssp, tracking

__all__ = ["components", "nhop", "pagerank", "sssp", "tracking"]
