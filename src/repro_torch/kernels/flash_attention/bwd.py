"""CUDA kernel wrapper: the flash-attention backward on Hopper (``sm_90a``).

Replaces no TPU kernel.  Neither Pallas attention kernel of the reference
has a backward: the reference trains by differentiating its jnp
``chunked_attention`` (``src/repro/models/attention.py:41``) with
``jax.value_and_grad`` (``src/repro/train/train_step.py``).  The port's
training forward runs kernel 3 (``kernel.py``), so its gradient is a
kernel written for the card too.  Source:
``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``.

What bounds it on this card: operations, 10·d per visible (query, key)
pair (five products of 2·d).  At the training layer shape of
starcoder2-7b (B 4, S 4,096, window 4,096, 36 heads over 4, d 128):
1.21e9 pairs, 1.55 TFLOP, 1.56 ms at 989 TFLOP/s.  The kernels issue
14·d a pair (the dQ pass recomputes S and dP), so that no float atomics
are needed and two launches give the same bits.

Three launches: (a) ``D = rowsum(dO·o)`` in float32; (b) one CTA per
(batch, KV head, block of keys) keeps dK and dV in registers, walks the
G query heads of its group and only the query blocks whose rows the
causal and window masks let see its keys, and recomputes
``P = exp(S·scale - lse)``; (c) one CTA per (batch, head, block of query
rows) keeps dQ in registers over the key blocks its rows see.  The route
depends on (dtype, head dim), as the forward's does, and is counted in
``launches_by_route``:

* ``bf16_wgmma`` (bf16, d 64 and 128; the training path): FA3's shape
  for Hopper.  wgmma products from shared memory (S, dP) and from
  registers (P and dS into dV, dK, dQ), TMA rings of Q/dO steps (dK/dV,
  128 keys a CTA) and of K/V blocks (dQ, 128 rows a CTA) fed by a
  warp-specialised producer, the mask only on edge blocks, the longest
  CTAs first.  ``schedule.bwd_schedule`` gives its blocks and launch
  order, ``schedule.tiled_bwd_ref`` follows them in plain PyTorch.
* ``bf16_mma_sync`` (bf16, d 16 and 32): ``mma.sync`` m16n8k16 with
  float32 accumulators (wgmma's swizzle wants rows of 64 bf16 or more).
* ``f32`` (float32): CUDA-core FMAs in full float32.

On a CPU tensor the wrapper runs the plain version (``ref.mha_bwd_ref``);
on a CUDA tensor it launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (
    DTYPE_CODES, HEAD_DIMS, _need)
from repro_torch.kernels.flash_attention.ref import mha_bwd_ref

#: the C entry point's route codes (``BwdRoute`` in the source)
ROUTES = ("f32", "bf16_mma_sync", "bf16_wgmma")


def flash_attention_bwd_cuda(
    q: torch.Tensor,  # (B, Sq, H, d)
    k: torch.Tensor,  # (B, Skv, K, d)
    v: torch.Tensor,  # (B, Skv, K, d)
    o: torch.Tensor,  # (B, Sq, H, d), the forward's output
    lse: torch.Tensor,  # (B, H, Sq) float32, the forward's log-sum-exp
    do: torch.Tensor,  # (B, Sq, H, d), the output's gradient
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
):
    """Gradients ``(dq, dk, dv)`` of flash attention, in the inputs'
    types, for the forward that gave ``o`` and ``lse``."""
    if q.device.type == "cpu":
        return mha_bwd_ref(q, k, v, o, lse, do, causal=causal,
                           window=window, q_offset=q_offset)
    _need(q.device.type == "cuda",
          f"tensors on {q.device} (need cuda, or cpu for the plain version)")
    _need(q.ndim == 4 and k.ndim == 4 and v.ndim == 4,
          "q, k, v must be (B, S, heads, d)")
    B, Sq, H, d = q.shape
    _, Skv, K, _ = k.shape
    _need(k.shape == v.shape and k.shape[0] == B and k.shape[3] == d,
          f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit q "
          f"{tuple(q.shape)}")
    _need(o.shape == q.shape and do.shape == q.shape,
          f"o {tuple(o.shape)} and do {tuple(do.shape)} must be q's shape")
    _need(lse.shape == (B, H, Sq) and lse.dtype == torch.float32,
          f"lse must be float32 {(B, H, Sq)}, got {lse.dtype} "
          f"{tuple(lse.shape)}")
    _need(H % K == 0, f"{H} query heads over {K} KV heads")
    _need(d in HEAD_DIMS, f"head dim {d} not in {HEAD_DIMS}")
    _need(q.dtype in DTYPE_CODES and all(
        t.dtype == q.dtype for t in (k, v, o, do)),
        f"q/k/v/o/do must share one of float32, bfloat16 (got {q.dtype}, "
        f"{k.dtype}, {v.dtype}, {o.dtype}, {do.dtype})")
    _need(all(t.device == q.device for t in (k, v, o, lse, do)),
          "all tensors must be on one device")
    _need(window >= 0 and q_offset >= 0, "window and q_offset must be >= 0")
    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lib = _build.library()
    scratch = torch.empty(lib.flash_attention_bwd_scratch(B, H, Sq),
                          dtype=torch.float32, device=q.device)
    route = ctypes.c_int(-1)
    code = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H, K, d, int(causal),
        int(window), int(q_offset), 1.0 / math.sqrt(d),
        DTYPE_CODES[q.dtype], ctypes.byref(route),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention_bwd_cuda")
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.launches_by_route[ROUTES[route.value]] += 1
    return dq, dk, dv


def reset_launches() -> None:
    """Set the launch counts, in total and by route, to 0."""
    flash_attention_bwd_cuda.launches = 0
    flash_attention_bwd_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)


#: calls that launched the backward kernels in this process (one call is
#: its three launches; the plain CPU path and empty inputs count nothing),
#: in total and by route
reset_launches()
