"""Plain PyTorch fused superstep stage — the oracle the CUDA kernel is held
against (counterpart of ``repro.kernels.semiring_superstep.ref``).

For every partition at once:

    y      = A_p^T x_in        (blocked SpMV over the packed tile list)
    x_out  = sr.add(x_comb, y)  with untouched blocks left at x_comb
    changed[p] = any(vmask_p & (x_out_p != x_ref_p))

``x_comb=None`` gives x_out = y (untouched blocks ``sr.zero``);
``x_ref=None`` skips the vote and returns ``changed=None``.

The query axis adds a leading Q to ``x_in``, ``x_comb``, ``x_ref``, the
output and the vote (``changed (Q, P, 1)``); ``vmask`` has none.  Lanes
run one by one.

Min-plus is bitwise equal to the kernel (min is exact in any order);
plus-mul reassociates the per-tile sums and is compared with a tolerance.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.semiring import Semiring
from repro_torch.kernels.semiring_spmm.ref import spmv_blocked_ref


def fused_step_ref(
    tiles: torch.Tensor,  # (P, T, B, B)
    rows: torch.Tensor,  # (P, T) int32, -1 = pad
    cols: torch.Tensor,  # (P, T) int32, -1 = pad
    x_in: torch.Tensor,  # (Pin, NVBin, B) — Pin == P, or 1 (shared)
    x_comb: Optional[torch.Tensor],  # (P, NVB, B) combine baseline
    x_ref: Optional[torch.Tensor],  # (P, NVB, B) halt-vote reference
    vmask: Optional[torch.Tensor],  # (P, NVB, B) valid mask (bool or 0/1)
    sr: Semiring,
    *,
    n_out_blocks: Optional[int] = None,  # NVB, when x_comb is None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns ``(x_out ([Q,] P, NVB, B), changed ([Q,] P, 1) int32 or
    None)``."""
    if x_in.ndim == 4:  # the query axis: each lane on its own
        outs = [fused_step_ref(
            tiles, rows, cols, x_in[q],
            None if x_comb is None else x_comb[q],
            None if x_ref is None else x_ref[q], vmask, sr,
            n_out_blocks=n_out_blocks) for q in range(x_in.shape[0])]
        return (torch.stack([o for o, _ in outs]),
                None if x_ref is None else torch.stack([c for _, c in outs]))
    P, B = tiles.shape[0], tiles.shape[-1]
    nvb = n_out_blocks if x_comb is None else x_comb.shape[1]
    # untouched output blocks carry sr.zero out of the SpMV, and
    # add(x, zero) == x — the baseline survives untouched blocks
    y = spmv_blocked_ref(tiles, rows, cols, x_in.reshape(x_in.shape[0], -1),
                         sr, n_out_blocks=nvb)
    if x_comb is not None:
        y = sr.add(x_comb.reshape(P, -1), y)
    x_out = y.reshape(P, nvb, B)
    if x_ref is None:
        return x_out, None
    live = vmask if vmask.dtype == torch.bool else vmask != 0
    changed = (live & (x_out != x_ref)).reshape(P, -1).any(dim=1)
    return x_out, changed.to(torch.int32)[:, None]
