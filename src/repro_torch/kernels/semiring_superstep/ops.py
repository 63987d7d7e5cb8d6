"""Dispatch for the fused superstep stage (counterpart of
``repro.kernels.semiring_superstep.ops``).

``fused_step(..., use_kernel=True)`` goes through the kernel wrapper (CUDA
kernel for CUDA tensors, plain version for CPU tensors);
``use_kernel=False`` runs the plain version directly.  ``vmask`` may be
bool or a 0/1 float mask, as in the reference; the kernel takes bool.
``x_comb=None`` (with ``n_out_blocks``) and ``x_ref=None`` drop the
combine and the vote, as the kernel wrapper describes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.semiring import Semiring
from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda
from repro_torch.kernels.semiring_superstep.ref import fused_step_ref


def fused_step(
    tiles: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    x_in: torch.Tensor,
    x_comb: Optional[torch.Tensor],
    x_ref: Optional[torch.Tensor],
    vmask: Optional[torch.Tensor],
    sr: Semiring,
    *,
    n_out_blocks: Optional[int] = None,
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One fused sweep/consume stage.  Returns ``(x_out, changed)``."""
    if vmask is not None and vmask.dtype != torch.bool:
        vmask = vmask != 0
    fn = fused_step_cuda if use_kernel else fused_step_ref
    return fn(tiles, rows, cols, x_in, x_comb, x_ref, vmask, sr,
              n_out_blocks=n_out_blocks)
