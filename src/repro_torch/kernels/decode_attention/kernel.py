"""CUDA kernel wrapper: decode attention on Hopper (``sm_90a``).

Replaces the TPU kernel ``decode_attention_pallas``
(``src/repro/kernels/decode_attention/kernel.py:83``, body
``_decode_kernel`` at ``:27``).  Source:
``src/repro_torch/kernels/csrc/decode_attention.cu``.

What bounds it on this card: memory.  One new token reads every valid
K/V slot once and does 4·G·d operations per 2·d·2 bytes of bf16 K/V, G
operations per byte (G = 9 for starcoder2-7b), far below the H100's ~295.
At starcoder2-7b's serving batch (4 sequences near 8.2k tokens, window
4,096, 4 KV heads, d = 128) one layer reads 33.6 MB: about 10 us at
3.35 TB/s (H100 SXM).

What the design does about it: the TPU kernel walks (B·K, kv block) in
order with one (G, d) query tile resident.  That grid gives only B·K
CTAs here (16 at the serving batch, on 132 SMs), so each sequence's
valid range is split (split-S flash decoding) in whole 64-key blocks, as
many splits as fill one wave of CTAs (``schedule.py``).  On the serving
route (bf16, d 64 or 128) a CTA's producer thread keeps a ring of two
K/V stages filled ahead by TMA (tensor maps over the cache as it lies,
two encoded per call), and four consumer warps run q.k and p.v on
``mma.sync`` tensor cores.  bf16 with d 16 or 32 and float32 keep the
first version's kernels (``cp.async`` per warp, CUDA cores in full
float32).  With several splits, a second launch combines them in split
order, on every route.  The route depends on (dtype, d) alone and is
counted in ``launches_by_route``.  The cache is read in place: no
transposed copy.

Sequences whose valid range is empty (``lengths[b] <= 0``) get 0, as in
the TPU kernel.

Host work per call is kept small (a decode step is host-bound): the SM
count is cached per device, the splits' partials take one allocation
from the caching allocator (on the caller's stream, so calls on several
streams or inside a CUDA-graph capture need nothing more), and check
messages are built only when a check fails.

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a
CUDA tensor it launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_ref
from repro_torch.kernels.decode_attention.schedule import num_splits
from repro_torch.kernels.flash_attention.kernel import (
    DTYPE_CODES, HEAD_DIMS, _check_heads_layout)

MAX_GROUP = 16  # query heads per KV head the kernel folds
#: the C entry point's route codes (``DecodeRoute`` in the source)
ROUTES = ("f32", "bf16_mma_sync", "bf16_ring")

_sms: dict = {}  # device index -> SM count


def _need(cond: bool, msg) -> None:
    """Raise unless ``cond``; ``msg`` is a string or a function making one
    (formatted only on failure)."""
    if not cond:
        raise ValueError(
            f"decode_attention_cuda: {msg() if callable(msg) else msg}")


def decode_attention_cuda(
    q: torch.Tensor,  # (B, H, d)
    k: torch.Tensor,  # (B, S, K, d)
    v: torch.Tensor,  # (B, S, K, d)
    lengths: torch.Tensor,  # (B,) int32, valid slots per sequence
    *,
    window: int = 0,
) -> torch.Tensor:
    """One query token per sequence against the cache; ``(B, H, d)``."""
    if q.device.type == "cpu":
        return decode_ref(q, k, v, lengths, window=window)
    _need(q.device.type == "cuda", lambda: f"tensors on {q.device} (need "
                                           f"cuda, or cpu for the plain "
                                           f"version)")
    _need(q.ndim == 3 and k.ndim == 4 and v.ndim == 4,
          "q must be (B, H, d), k/v (B, S, K, d)")
    B, H, d = q.shape
    _, S, K, _ = k.shape
    _need(k.shape == v.shape and k.shape[0] == B and k.shape[3] == d,
          lambda: f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit q "
                  f"{tuple(q.shape)}")
    _need(H % K == 0 and H // K <= MAX_GROUP,
          lambda: f"{H} query heads over {K} KV heads (at most {MAX_GROUP} "
                  f"per KV head)")
    _need(d in HEAD_DIMS, lambda: f"head dim {d} not in {HEAD_DIMS}")
    _need(q.dtype in DTYPE_CODES and k.dtype == q.dtype
          and v.dtype == q.dtype,
          lambda: f"q/k/v must share one of float32, bfloat16 (got "
                  f"{q.dtype}, {k.dtype}, {v.dtype})")
    _need(lengths.dtype == torch.int32 and lengths.shape == (B,)
          and lengths.is_contiguous(), "lengths must be (B,) int32, "
                                       "contiguous")
    _need(k.device == q.device and v.device == q.device
          and lengths.device == q.device, "all tensors must be on one device")
    _need(q.stride(2) == 1 and q.stride(1) == d,
          lambda: f"q needs a contiguous head dim and packed heads, strides "
                  f"{q.stride()}")
    _need(q.data_ptr() % 16 == 0 and q.stride(0) % (16 // q.element_size())
          == 0, "q must be 16-byte aligned")
    _check_heads_layout(k, "k", _need)
    _check_heads_layout(v, "v", _need)
    _need(window >= 0, "window must be >= 0")
    o = torch.empty((B, H, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0 or S == 0:
        return o.zero_()
    dev = q.device
    sms = _sms.get(dev.index)
    if sms is None:
        sms = _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    nsplit = num_splits(B * K, min(S, window) if window else S, sms)
    G = H // K
    ws_acc = ws_ml = None
    if nsplit > 1:
        slots = B * K * nsplit * G
        ws = torch.empty(slots * (d + 2), device=dev)
        ws_acc = ws.data_ptr()
        ws_ml = ws_acc + slots * d * 4  # (m, l) pairs after the partials
    route = ctypes.c_int(-1)
    code = _build.library().decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), ws_acc, ws_ml,
        B, S, H, K, d, q.stride(0), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), o.stride(0), int(window), nsplit, 1.0 / math.sqrt(d),
        DTYPE_CODES[q.dtype], ctypes.byref(route),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "decode_attention_cuda")
    decode_attention_cuda.launches += 1
    decode_attention_cuda.launches_by_route[ROUTES[route.value]] += 1
    return o


def reset_launches() -> None:
    """Set the launch counts, in total and by route, to 0."""
    decode_attention_cuda.launches = 0
    decode_attention_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)


#: calls that launched the CUDA kernels in this process (one per call,
#: with or without the second launch that combines the splits), in total
#: and by the route the C entry point took; the plain CPU path and empty
#: inputs launch nothing and count nothing
reset_launches()
