"""Plain PyTorch blocked semiring SpMV — the oracle the CUDA kernel is held
against (counterpart of ``repro.kernels.semiring_spmm.ref``).

y[cb*B + j] = add-reduce over tiles t with col(t)==cb, over i of
              mul(x[row(t)*B + i], tiles[t, i, j])

The tile axis may be the dense template list or a block-sparse packed list.
Padding tiles carry (rows, cols) == -1 and are routed to an overflow
segment that is sliced off, so the oracle is safe for any fill value;
blocks with no tile come back as the semiring zero.  ``nnz`` (optional)
additionally treats every step at or past the valid count as padding, as
the kernel's walk does.

Two forms: one partition ``(T, B, B)`` tiles with ``(T,)`` rows/cols and
an ``(nvb*B,)`` state, or all partitions at once: ``(P, T, B, B)`` tiles,
``(P, T)`` rows/cols and an ``(Px, nvb*B)`` state with ``Px`` in {P, 1}
(1 = one state shared by every partition, the boundary consume).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.semiring import Semiring


def spmv_blocked_ref(
    tiles: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    x: torch.Tensor,
    sr: Semiring,
    n_out_blocks: Optional[int] = None,
    nnz=None,
) -> torch.Tensor:
    single = tiles.ndim == 3
    if single:
        tiles, rows, cols, x = tiles[None], rows[None], cols[None], x[None]
        if nnz is not None:
            nnz = torch.as_tensor(nnz).reshape(1)
    P, T, B, _ = tiles.shape
    nvb = x.shape[-1] // B
    nob = n_out_blocks if n_out_blocks is not None else nvb
    dev = tiles.device
    xb = x.reshape(x.shape[0], nvb, B)
    r = rows.long().clamp_min(0)  # padding reads block 0, contributes nothing
    if x.shape[0] == 1:
        xg = xb[0][r]  # (P, T, B)
    else:
        xg = xb[torch.arange(P, device=dev)[:, None], r]
    prod = sr.mul(xg[..., None], tiles)  # (P, T, B, B)
    part = sr.add_reduce(prod, 2)  # (P, T, B) per-tile output partial
    valid = cols >= 0
    if nnz is not None:
        n = torch.as_tensor(nnz, device=dev).reshape(-1, 1)
        valid = valid & (torch.arange(T, device=dev)[None, :] < n)
    seg = torch.where(valid, cols.long(), nob)
    seg = seg + torch.arange(P, device=dev)[:, None] * (nob + 1)
    y = sr.segment_reduce(part.reshape(P * T, B), seg.reshape(-1),
                          P * (nob + 1))
    y = y.reshape(P, nob + 1, B)[:, :nob].reshape(P, nob * B)
    return y[0] if single else y
