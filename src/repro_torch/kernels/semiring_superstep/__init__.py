"""Fused superstep stage: sweep + semiring combine + halt vote in one
launch.  ``kernel.py`` holds the CUDA wrapper, ``ref.py`` the plain
version, ``ops.py`` the dispatch used by ``repro_torch.core.superstep``."""
from repro_torch.kernels.semiring_superstep.ops import fused_step  # noqa: F401
from repro_torch.kernels.semiring_superstep.ref import fused_step_ref  # noqa: F401
