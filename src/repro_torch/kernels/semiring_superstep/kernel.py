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
tile byte).  The least time is the valid tiles' bytes plus the states it
reads and writes over HBM bandwidth: 0.0245 ms for the TR_SMALL local
sweep (82 MB) and 0.0553 ms for its boundary consume (185 MB) on an H100
SXM at 3.35 TB/s.  (Counting the padded ``t_max`` x P tiles instead of
the valid ones, as an earlier note did, gives 32 and 106 us; the kernel
reads only valid tiles.)

What the design does about it: the TPU kernel walks (P, T) in order with
a double-buffered tile DMA and the partition state resident in VMEM.
Here the SpMV's walk (``csrc/blocked_walk.cuh``) does the fold: one CTA
per chunk of the walk plan (``kernels/walk_plan.py``), a TMA-fed ring of
shared-memory stages, and the chunks of a run combined in chunk order by
the CTA that finishes the run.  That CTA applies the combine and votes,
for EVERY block of the partition — a block with an empty run has one
empty chunk, copies ``x_comb`` and still votes.  The vote is a
block-wide OR (``__syncthreads_or``) and one ``atomicOr`` per voting CTA
into a ``changed`` buffer zeroed before the launch; the state itself
takes no atomics.  Both kernels fold in the same order, so the fused
and the SpMV mode agree bitwise, plus-mul included.

The query axis: for Q lanes of states (the reference ``vmap``s the TPU
kernel over them, which adds a grid axis over Q), one launch serves
every lane, with a vote per lane and partition, ``changed (Q, P, 1)``.
``vmask`` has no lane axis.  A CTA folds its chunk for every lane group
(``walk_plan.lane_group``) from one read of each weight per group, as
in the SpMV; at Q = 32 the operations bound the launch.

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.semiring import Semiring
from repro_torch.kernels import _build
from repro_torch.kernels.semiring_superstep.ref import fused_step_ref
from repro_torch.kernels.walk_plan import WalkPlan, kernel_plan


def _need(cond: bool, msg) -> None:
    """Raise unless ``cond``.  ``msg`` is a string, or a function that
    makes one: these checks run on every launch, and a formatted message
    is built only when one fails."""
    if not cond:
        text = msg() if callable(msg) else msg
        raise ValueError(f"fused_step_cuda: {text}")


def _aligned16(t: torch.Tensor) -> bool:
    """16-byte aligned for the kernel's float4 reads in every lane and
    partition: the base pointer and every stride but the last.  (A
    contiguous tensor can still start off 16 bytes, and is_contiguous()
    says nothing about the lane stride of a strided view.)"""
    return t.data_ptr() % 16 == 0 and all(
        st % 4 == 0 for st in t.stride()[:-1])


def fused_step_cuda(
    tiles: torch.Tensor,  # (P, T, B, B) float32
    rows: torch.Tensor,  # (P, T) int32, -1 = pad
    cols: torch.Tensor,  # (P, T) int32, -1 = pad (sorted last)
    x_in: torch.Tensor,  # ([Q,] Pin, NVBin, B) float32; Pin in {P, 1}
    x_comb: Optional[torch.Tensor],  # ([Q,] P, NVB, B) float32
    x_ref: Optional[torch.Tensor],  # ([Q,] P, NVB, B) float32
    vmask: Optional[torch.Tensor],  # (P, NVB, B) bool, no lane axis
    sr: Semiring,
    *,
    n_out_blocks: Optional[int] = None,  # NVB, when x_comb is None
    plan: Optional[WalkPlan] = None,  # device plan of cols
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns ``(x_out (P, NVB, B), changed (P, 1) int32)``; for Q lanes
    (the query axis: ``x_in`` of rank 4 and the states with a leading Q)
    ``(x_out (Q, P, NVB, B), changed (Q, P, 1))`` from one launch.

    ``x_comb=None``: x_out = y (untouched blocks get ``sr.zero``).
    ``x_ref=None``: no vote; ``vmask`` is not read and ``changed`` is
    ``None``.  ``plan``: the walk plan of ``cols`` for NVB output blocks
    (:func:`~repro_torch.kernels.walk_plan.to_device`); built on the
    device when omitted.  The plain CPU path ignores it."""
    if tiles.device.type == "cpu":
        return fused_step_ref(tiles, rows, cols, x_in, x_comb, x_ref, vmask,
                              sr, n_out_blocks=n_out_blocks)
    _need(tiles.device.type == "cuda",
          lambda: f"tensors on {tiles.device} (need cuda, or cpu for the "
          f"plain version)")
    _need(tiles.ndim == 4 and tiles.shape[2] == tiles.shape[3],
          lambda: f"tiles must be (P, T, B, B), got {tuple(tiles.shape)}")
    P, T, B, _ = tiles.shape
    _need(rows.shape == (P, T) and cols.shape == (P, T),
          lambda: f"rows/cols must be {(P, T)}")
    lanes = x_in.ndim == 4
    Q = x_in.shape[0] if lanes else 1
    lead = (Q,) if lanes else ()
    nvb = n_out_blocks if x_comb is None else x_comb.shape[-2]
    _need(nvb is not None, "x_comb=None needs n_out_blocks")
    states = [t for t in (x_comb, x_ref) if t is not None]
    _need(all(t.shape == lead + (P, nvb, B) for t in states),
          lambda: f"x_comb and x_ref must be {lead + (P, nvb, B)}")
    _need(x_ref is None or (vmask is not None
                            and vmask.shape == (P, nvb, B)),
          "the vote needs vmask of shape (P, NVB, B)")
    _need(x_in.ndim == len(lead) + 3 and x_in.shape[-3] in (1, P)
          and x_in.shape[-1] == B,
          lambda: f"x_in must be ([Q,] P or 1, NVBin, B), got "
          f"{tuple(x_in.shape)}")
    _need(all(t.dtype == torch.float32 for t in [tiles, x_in] + states),
          "tiles and states must be float32")
    _need(rows.dtype == torch.int32 and cols.dtype == torch.int32,
          "rows and cols must be int32")
    vm = None if x_ref is None else vmask  # read only for the vote
    _need(vm is None or vm.dtype == torch.bool, "vmask must be bool")
    ts = [tiles, rows, cols, x_in] + states + ([] if vm is None else [vm])
    _need(all(t.device == tiles.device for t in ts),
          "all tensors must be on one device")
    _need(all(t.is_contiguous() for t in [tiles, rows, cols] + states
              + ([] if vm is None else [vm])),
          "tiles, rows, cols and the states must be contiguous")
    # x_in is read a float at a time: each (lane, partition) block of
    # (NVBin, B) must be contiguous, the lane and partition strides may
    # be anything (the consume's boundary is shared by partitions, not
    # by lanes)
    _need(x_in.shape[-2] <= 1 or tuple(x_in.stride()[-2:]) == (B, 1),
          "x_in's (NVBin, B) blocks must be contiguous")
    _need(B % 4 == 0 and B <= 1024,
          lambda: f"block size {B} must be a multiple of 4, at most "
          f"1024")
    _need(all(_aligned16(t) for t in [tiles] + states)
          and (vm is None or vm.data_ptr() % 4 == 0),
          "tiles and states must be 16-byte aligned in every lane, vmask "
          "4-byte")
    x_out = torch.empty(lead + (P, nvb, B), dtype=torch.float32,
                        device=tiles.device)
    changed = None if x_ref is None else torch.zeros(
        lead + (P, 1), dtype=torch.int32, device=tiles.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    if x_out.numel():
        plan, partials = kernel_plan(plan, cols, nvb, None, B, _need, Q)
        lib = _build.library()
        xq = x_in if lanes else x_in[None]
        code = lib.fused_step_f32(
            tiles.data_ptr(), rows.data_ptr(), xq.data_ptr(), ptr(x_comb),
            ptr(x_ref), ptr(vm), x_out.data_ptr(), ptr(changed),
            plan.chunks.data_ptr(), plan.first.data_ptr(),
            plan.count.data_ptr(), plan.counters.data_ptr(),
            partials.data_ptr(), T, B, plan.chunks.shape[0], plan.chunk, P,
            Q, xq.stride(0), 0 if xq.shape[1] == 1 else xq.stride(1), nvb,
            _build.SEMIRING_CODES[sr.name],
            torch.cuda.current_stream(tiles.device).cuda_stream)
        _build.check(code, "fused_step_cuda")
        fused_step_cuda.launches += 1
    return x_out, changed


#: launches of the CUDA kernel in this process (the plain CPU path and
#: empty outputs launch nothing and count nothing); a launch serves every
#: lane of the query axis
fused_step_cuda.launches = 0
