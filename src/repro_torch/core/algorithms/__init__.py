"""The analytics' numpy parts: host iBSP Computes and ``run_host``
(sssp, pagerank, nhop, tracking), oracles and edge-weight transforms.
Importing the package registers the Gopher analytics ``sssp``,
``pagerank``, ``components``, ``nhop`` and ``tracking``
(``repro_torch.gopher``)."""
from repro_torch.core.algorithms import components, nhop, pagerank, sssp, tracking

__all__ = ["components", "nhop", "pagerank", "sssp", "tracking"]
