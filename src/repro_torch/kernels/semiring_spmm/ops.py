"""Dispatch for the blocked semiring SpMV (counterpart of
``repro.kernels.semiring_spmm.ops``).

``spmv_blocked(..., use_kernel=True)`` goes through the kernel wrapper,
which launches the CUDA kernel for CUDA tensors and runs the plain version
for CPU tensors; ``use_kernel=False`` runs the plain version directly (the
``"off"`` engine mode, allowed on the CPU only).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.semiring import Semiring
from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
from repro_torch.kernels.semiring_spmm.ref import spmv_blocked_ref


def spmv_blocked(
    tiles: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    x: torch.Tensor,
    sr: Semiring,
    *,
    n_out_blocks: Optional[int] = None,
    use_kernel: bool = True,
    nnz=None,
) -> torch.Tensor:
    if use_kernel:
        return spmv_blocked_cuda(tiles, rows, cols, x, sr,
                                 n_out_blocks=n_out_blocks, nnz=nnz)
    return spmv_blocked_ref(tiles, rows, cols, x, sr,
                            n_out_blocks=n_out_blocks, nnz=nnz)
