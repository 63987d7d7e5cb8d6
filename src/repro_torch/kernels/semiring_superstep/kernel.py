"""CUDA kernel wrapper: the fused superstep stage on Hopper (``sm_90a``).

Replaces the TPU kernel ``fused_step_pallas``
(``src/repro/kernels/semiring_superstep/kernel.py:142``, body
``_fused_kernel`` at ``:51``).  Source:
``src/repro_torch/kernels/csrc/semiring_superstep.cu`` with the run walk
shared with the SpMV kernel in ``csrc/blocked_walk.cuh``.

One launch does, for every partition: the blocked SpMV walk, the semiring
combine ``x_out = add(x_comb, y)`` (untouched blocks keep ``x_comb``) and
the halt vote ``changed[p] = any(vmask & (x_out != x_ref))``, so the
BSP loop reads P flags instead of re-reading two full states.  Where a
caller needs neither (PageRank's step), ``x_comb=None`` combines with the
semiring zero and ``x_ref=None`` skips the vote: no zero state is built
and no state is read for a vote nobody reads.

What bounds it on this card: memory, as for the SpMV (0.5 operation per
tile byte).  The least time is the tile bytes plus the four (P, Vp)
states over HBM bandwidth: about 32 us for the TR_SMALL local sweep and
106 us for its boundary consume on an H100 SXM at 3.35 TB/s.

What the design does about it: the TPU kernel walks (P, T) in order with
a double-buffered tile DMA and the partition state resident in VMEM.
Here one CTA owns one (partition, output block) for EVERY block of the
partition — blocks without tiles copy ``x_comb`` and still vote — and
streams its run's tiles as 16-byte loads in a fixed fold order.  The
vote is a block-wide OR (``__syncthreads_or``) and one ``atomicOr`` per
voting CTA into a ``changed`` buffer zeroed before the launch; the state
itself takes no atomics.

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.semiring import Semiring
from repro_torch.kernels import _build
from repro_torch.kernels.semiring_superstep.ref import fused_step_ref


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_step_cuda: {msg}")


def fused_step_cuda(
    tiles: torch.Tensor,  # (P, T, B, B) float32
    rows: torch.Tensor,  # (P, T) int32, -1 = pad
    cols: torch.Tensor,  # (P, T) int32, -1 = pad (sorted last)
    x_in: torch.Tensor,  # (Pin, NVBin, B) float32; Pin in {P, 1}
    x_comb: Optional[torch.Tensor],  # (P, NVB, B) float32
    x_ref: Optional[torch.Tensor],  # (P, NVB, B) float32
    vmask: Optional[torch.Tensor],  # (P, NVB, B) bool
    sr: Semiring,
    *,
    n_out_blocks: Optional[int] = None,  # NVB, when x_comb is None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns ``(x_out (P, NVB, B), changed (P, 1) int32)``.

    ``x_comb=None``: x_out = y (untouched blocks get ``sr.zero``).
    ``x_ref=None``: no vote; ``vmask`` is not read and ``changed`` is
    ``None``."""
    if tiles.device.type == "cpu":
        return fused_step_ref(tiles, rows, cols, x_in, x_comb, x_ref, vmask,
                              sr, n_out_blocks=n_out_blocks)
    _need(tiles.device.type == "cuda",
          f"tensors on {tiles.device} (need cuda, or cpu for the plain "
          f"version)")
    _need(tiles.ndim == 4 and tiles.shape[2] == tiles.shape[3],
          f"tiles must be (P, T, B, B), got {tuple(tiles.shape)}")
    P, T, B, _ = tiles.shape
    _need(rows.shape == (P, T) and cols.shape == (P, T),
          f"rows/cols must be {(P, T)}")
    nvb = n_out_blocks if x_comb is None else x_comb.shape[1]
    _need(nvb is not None, "x_comb=None needs n_out_blocks")
    states = [x_in] + [t for t in (x_comb, x_ref) if t is not None]
    _need(all(t.shape == (P, nvb, B) for t in states[1:]),
          f"x_comb and x_ref must be {(P, nvb, B)}")
    _need(x_ref is None or (vmask is not None
                            and vmask.shape == x_ref.shape),
          "the vote needs vmask of x_ref's shape")
    _need(x_in.ndim == 3 and x_in.shape[0] in (1, P) and x_in.shape[2] == B,
          f"x_in must be (P or 1, NVBin, B), got {tuple(x_in.shape)}")
    _need(all(t.dtype == torch.float32 for t in [tiles] + states),
          "tiles and states must be float32")
    _need(rows.dtype == torch.int32 and cols.dtype == torch.int32,
          "rows and cols must be int32")
    vm = None if x_ref is None else vmask  # read only for the vote
    _need(vm is None or vm.dtype == torch.bool, "vmask must be bool")
    ts = [tiles, rows, cols] + states + ([] if vm is None else [vm])
    _need(all(t.device == tiles.device for t in ts),
          "all tensors must be on one device")
    _need(all(t.is_contiguous() for t in ts),
          "all tensors must be contiguous")
    _need(B % 4 == 0, f"block size {B} must be a multiple of 4")
    _need(all(t.data_ptr() % 16 == 0 for t in [tiles] + states[1:])
          and (vm is None or vm.data_ptr() % 4 == 0),
          "tiles and states must be 16-byte aligned, vmask 4-byte")
    x_out = torch.empty((P, nvb, B), dtype=torch.float32,
                        device=tiles.device)
    changed = None if x_ref is None else torch.zeros(
        (P, 1), dtype=torch.int32, device=tiles.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    if x_out.numel():
        lib = _build.library()
        code = lib.fused_step_f32(
            tiles.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            x_in.data_ptr(), ptr(x_comb), ptr(x_ref), ptr(vm),
            x_out.data_ptr(), ptr(changed), P, T, B,
            0 if x_in.shape[0] == 1 else x_in.shape[1] * B, nvb,
            _build.SEMIRING_CODES[sr.name],
            torch.cuda.current_stream(tiles.device).cuda_stream)
        _build.check(code, "fused_step_cuda")
        fused_step_cuda.launches += 1
    return x_out, changed


#: launches of the CUDA kernel in this process (the plain CPU path and
#: empty outputs launch nothing and count nothing)
fused_step_cuda.launches = 0
