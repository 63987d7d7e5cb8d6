"""The analytics' numpy parts: host iBSP Computes and ``run_host``
(sssp, pagerank, nhop, tracking), oracles and edge-weight transforms.
Importing the package registers the Gopher analytics ``sssp``,
``pagerank``, ``components`` and ``nhop`` (``repro_torch.gopher``);
``tracking``'s entry waits for the query axis (ROADMAP queue 1, item 2)."""
from repro_torch.core.algorithms import components, nhop, pagerank, sssp, tracking

__all__ = ["components", "nhop", "pagerank", "sssp", "tracking"]
