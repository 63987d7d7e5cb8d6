"""CUDA kernel wrapper: flash attention for prefill on Hopper (``sm_90a``).

Replaces the TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention/kernel.py:86``, body
``_flash_kernel`` at ``:27``).  Source:
``src/repro_torch/kernels/csrc/flash_attention.cu``.

What bounds it on this card: operations.  Each visible (query, key) pair
costs 4·d floating-point operations (two products) on 2·d·2 bytes of K/V
that every query head of a block reuses, far above the H100's ~295 bf16
operations per byte of HBM bandwidth.  At the serving batch of
starcoder2-7b (4 prompts of 8,192 tokens, 36 heads, d = 128, window
4,096) one layer sees 100.7M pairs per head: 1.86 TFLOP, or about 1.9 ms
at 989 TFLOP/s dense bf16 (H100 SXM).

What the design does about it (bf16, d in {64, 128}, the serving path):
the TPU kernel walks a (BH, q block, kv block) grid in order with the
accumulators in VMEM and skips masked kv blocks.  Here a CTA owns 128
query rows of one head: two consumer warpgroups run both products on
``wgmma`` (S = Q·Kᵀ from shared memory, P·V with P from registers and V
through the transposed-B descriptor), while one producer thread keeps
K/V blocks of 128 keys flowing into a three-stage shared-memory ring
with TMA tensor maps over the tensors as they lie.  So the consumers
issue no load instructions, which set the pace of the first
(``mma.sync``) version.  Each warpgroup issues Q·Kᵀ of one block with
P·V of the block before and runs the softmax while P·V is in flight.
Only the edge blocks of a query block's key range evaluate the mask
(``schedule.py`` holds the same block schedule for the CPU tests).
K/V are read in place from the KV cache, query head h from KV head
h // G: no repeated or transposed copy.  bf16 with d in {16, 32} takes
the first version's ``mma.sync`` kernel (``flash_fwd_bf16_small``);
float32 a CUDA-core kernel in full float32 (no TF32).  The route depends
on (dtype, d) alone and is counted in ``launches_by_route``.

Rows that see no key at all (only possible when ``q_offset + Sq >
Skv + window``, never on the serving path) get 0 where their whole query
block sees none, as in the TPU kernel.

With ``return_lse=True`` (the training forward, ``models.attention``'s
``FlashAttentionFn``) every route also writes each row's log-sum-exp
``m + log l`` (float32 (B, H, Sq), natural log of the scaled logits, -inf
for a row that sees no key), which the backward kernel
(``bwd.flash_attention_bwd_cuda``) recomputes the probabilities from.
Without it the kernel is given a null pointer and computes what it
computed before, bit for bit.

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import mha_ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the C entry point's route codes (``FlashRoute`` in the source)
ROUTES = ("f32", "bf16_mma_sync", "bf16_wgmma")


def _need(cond: bool, msg) -> None:
    """Raise unless ``cond``; ``msg`` is a string or a function making one
    (formatted only on failure)."""
    if not cond:
        raise ValueError(
            f"flash_attention_cuda: {msg() if callable(msg) else msg}")


def _check_heads_layout(t: torch.Tensor, name: str, need) -> None:
    """(B, S, n, d) with the head dim contiguous and heads packed; batch
    and row strides free (a slice of the KV cache), 16-byte aligned."""
    d = t.shape[-1]
    need(t.stride(3) == 1 and t.stride(2) == d,
         lambda: f"{name} needs a contiguous head dim and packed heads, "
                 f"strides {t.stride()}")
    per16 = 16 // t.element_size()
    need(t.stride(0) % per16 == 0 and t.stride(1) % per16 == 0,
         lambda: f"{name} batch/row strides must be multiples of 16 bytes")
    need(t.data_ptr() % 16 == 0, lambda: f"{name} must be 16-byte aligned")


def flash_attention_cuda(
    q: torch.Tensor,  # (B, Sq, H, d)
    k: torch.Tensor,  # (B, Skv, K, d)
    v: torch.Tensor,  # (B, Skv, K, d)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Attention of q over k/v; returns ``(B, Sq, H, d)`` in q's type, and
    with ``return_lse`` also the float32 ``(B, H, Sq)`` log-sum-exp."""
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window,
                       q_offset=q_offset, return_lse=return_lse)
    _need(q.device.type == "cuda",
          f"tensors on {q.device} (need cuda, or cpu for the plain version)")
    _need(q.ndim == 4 and k.ndim == 4 and v.ndim == 4,
          "q, k, v must be (B, S, heads, d)")
    B, Sq, H, d = q.shape
    _, Skv, K, _ = k.shape
    _need(k.shape == v.shape and k.shape[0] == B and k.shape[3] == d,
          f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit q "
          f"{tuple(q.shape)}")
    _need(H % K == 0, f"{H} query heads over {K} KV heads")
    _need(d in HEAD_DIMS, f"head dim {d} not in {HEAD_DIMS}")
    _need(q.dtype in DTYPE_CODES and k.dtype == q.dtype
          and v.dtype == q.dtype,
          f"q/k/v must share one of float32, bfloat16 (got {q.dtype}, "
          f"{k.dtype}, {v.dtype})")
    _need(k.device == q.device and v.device == q.device,
          "all tensors must be on one device")
    _need(q.is_contiguous(), "q must be contiguous")
    _need(q.data_ptr() % 16 == 0, "q must be 16-byte aligned")
    _check_heads_layout(k, "k", _need)
    _check_heads_layout(v, "v", _need)
    _need(window >= 0 and q_offset >= 0, "window and q_offset must be >= 0")
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() == 0 or Skv == 0:
        o.zero_()
        if lse is None:
            return o
        return o, lse.fill_(float("-inf"))
    route = ctypes.c_int(-1)
    code = _build.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, Skv, H, K, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1),
        int(causal), int(window), int(q_offset), 1.0 / math.sqrt(d),
        DTYPE_CODES[q.dtype], ctypes.byref(route),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention_cuda")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_route[ROUTES[route.value]] += 1
    return o if lse is None else (o, lse)


def reset_launches() -> None:
    """Set the launch counts, in total and by route, to 0."""
    flash_attention_cuda.launches = 0
    flash_attention_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)


#: launches of the CUDA kernel in this process (the plain CPU path and
#: empty inputs launch nothing and count nothing), in total and by the
#: route the C entry point took
reset_launches()
