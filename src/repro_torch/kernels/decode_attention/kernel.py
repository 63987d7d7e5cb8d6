"""CUDA kernel wrapper: decode attention on Hopper (``sm_90a``).

Replaces the TPU kernel ``decode_attention_pallas``
(``src/repro/kernels/decode_attention/kernel.py:83``, body
``_decode_kernel`` at ``:27``).  Source:
``src/repro_torch/kernels/csrc/decode_attention.cu``.

What bounds it on this card: memory.  One new token reads every valid
K/V slot once and does 4·G·d operations per 2·d·2 bytes of bf16 K/V, G
operations per byte (G = 9 for starcoder2-7b), far below the H100's ~295.
At starcoder2-7b's serving batch (4 sequences near 8.2k tokens, window
4,096, 4 KV heads, d = 128) one layer reads 33.5 MB: about 10 us at
3.35 TB/s (H100 SXM).

What the design does about it: the TPU kernel walks (B·K, kv block) in
order with one (G, d) query tile resident.  That grid gives only B·K
CTAs here (16 at the serving batch, on 132 SMs), so the kernel splits
each sequence's window into ``nsplit`` even shares (split-S flash
decoding): a CTA takes the G queries of one KV head over its share, its
four warps taking turns at 32-key blocks, and writes a partial (acc, m,
l); a second small kernel combines the splits in a fixed split order, so
results do not depend on scheduling.  With one split the first kernel
writes the output itself.  bf16 puts the G <= 16 query rows in one
16-row tensor-core tile (``mma.sync`` m16n8k16 for q.k and p.v), each
warp copying its K/V block into shared memory with 16-byte ``cp.async``;
float32 runs on CUDA cores in full float32.  The cache is read in place:
no transposed copy.

Sequences with ``lengths[b] <= 0`` get 0, as in the TPU kernel; lengths
above the cache size are clamped to it.

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a
CUDA tensor it launches the kernels or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_ref
from repro_torch.kernels.flash_attention.kernel import (
    DTYPE_CODES, HEAD_DIMS, _check_heads_layout)

MAX_GROUP = 16  # query heads per KV head the kernel folds
SPLIT_KEYS = 128  # fewest keys a split is given (one step of its 4 warps)


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode_attention_cuda: {msg}")


def num_splits(batch_kv_heads: int, span: int, sms: int) -> int:
    """Splits per (batch, KV head): enough CTAs for one per SM, but no
    split shorter than ``SPLIT_KEYS`` keys of the longest span.  (At the
    serving shape, one CTA per SM timed faster than two: ``chip_smoke.py``
    sweeps the split count.)"""
    want = -(-sms // max(batch_kv_heads, 1))
    return max(1, min(want, -(-span // SPLIT_KEYS)))


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
    _need(q.device.type == "cuda",
          f"tensors on {q.device} (need cuda, or cpu for the plain version)")
    _need(q.ndim == 3 and k.ndim == 4 and v.ndim == 4,
          "q must be (B, H, d), k/v (B, S, K, d)")
    B, H, d = q.shape
    _, S, K, _ = k.shape
    _need(k.shape == v.shape and k.shape[0] == B and k.shape[3] == d,
          f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit q "
          f"{tuple(q.shape)}")
    _need(H % K == 0 and H // K <= MAX_GROUP,
          f"{H} query heads over {K} KV heads (at most {MAX_GROUP} per KV "
          f"head)")
    _need(d in HEAD_DIMS, f"head dim {d} not in {HEAD_DIMS}")
    _need(q.dtype in DTYPE_CODES and k.dtype == q.dtype
          and v.dtype == q.dtype,
          f"q/k/v must share one of float32, bfloat16 (got {q.dtype}, "
          f"{k.dtype}, {v.dtype})")
    _need(lengths.dtype == torch.int32 and lengths.shape == (B,)
          and lengths.is_contiguous(), "lengths must be (B,) int32, "
                                       "contiguous")
    _need(all(t.device == q.device for t in (k, v, lengths)),
          "all tensors must be on one device")
    _need(q.stride(2) == 1 and q.stride(1) == d,
          f"q needs a contiguous head dim and packed heads, strides "
          f"{q.stride()}")
    _need(q.data_ptr() % 16 == 0 and q.stride(0) % (16 // q.element_size())
          == 0, "q must be 16-byte aligned")
    _check_heads_layout(k, "k", _need)
    _check_heads_layout(v, "v", _need)
    _need(window >= 0, "window must be >= 0")
    o = torch.empty((B, H, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0 or S == 0:
        return o.zero_()
    span = min(S, window) if window else S
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit = num_splits(B * K, span, sms)
    G = H // K
    ws_acc = ws_ml = None
    if nsplit > 1:
        ws_acc = torch.empty(B * K * nsplit * G * d, dtype=torch.float32,
                             device=q.device)
        ws_ml = torch.empty(B * K * nsplit * G * 2, dtype=torch.float32,
                            device=q.device)
    code = _build.library().decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), None if ws_acc is None else ws_acc.data_ptr(),
        None if ws_ml is None else ws_ml.data_ptr(),
        B, S, H, K, d, q.stride(0), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), o.stride(0), int(window), nsplit, 1.0 / math.sqrt(d),
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "decode_attention_cuda")
    decode_attention_cuda.launches += 1
    return o


#: calls that launched the CUDA kernels in this process (one per call:
#: the split pass and, with more than one split, the combine); the plain
#: CPU path launches nothing and counts nothing
decode_attention_cuda.launches = 0
