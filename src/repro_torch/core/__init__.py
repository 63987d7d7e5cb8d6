"""GoFFish core on PyTorch: time-series graph model, partitioning, blocked
layout, semirings, stacked comm, BSP superstep drivers and the temporal
engine.  Import the submodules directly (``repro_torch.core.engine`` ...)."""
