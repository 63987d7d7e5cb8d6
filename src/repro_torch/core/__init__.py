"""GoFFish core on PyTorch: time-series graph model, partitioning and
subgraph discovery, subgraph topologies, the host iBSP engine, blocked
layout, semirings, stacked comm, BSP superstep drivers and the temporal
engine.  Import the submodules directly (``repro_torch.core.engine`` ...)."""
