"""The decode kernel's split schedule, checkable on the CPU.

A sequence's valid cache slots are ``[lo, hi)``: ``hi = min(len, S)`` and,
with a window ``w > 0``, ``lo = max(0, len - w)``, else 0 (the reference's
mask: slot j is valid when j < len, j < S and j > len - 1 - w).  The
range is cut into blocks of ``KB`` keys from ``lo``; split ``s`` of
``nsplit`` takes blocks ``[s·nb, (s+1)·nb)`` with ``nb =
ceil(ceil((hi - lo) / KB) / nsplit)``.  ``num_splits`` picks ``nsplit``
so that the B·K·nsplit CTAs fill one wave of the card and no split is
shorter than a block.  The formulas are the kernel's
(``csrc/decode_attention.cu``, ``split_range``).

``tiled_ref`` follows that schedule and the ring kernel's arithmetic in
plain PyTorch: within a split, four warps each take 16 keys of every
block with their own online softmax in float32 (masked keys take p = 0,
``p`` rounded to ``v``'s type before ``p.v`` with ``l`` summed from the
unrounded ``p``), merged in warp order; then the splits are combined in
split order and the output is ``acc / max(l, 1e-30)`` in q's type.  An
empty range gives 0, as in the TPU kernel.  The tests hold it against the
reference's Pallas kernel in interpret mode, its jnp oracle and
``decode_ref``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30
KB = 64  # keys per block
WARPS = 4  # consumer warps of a CTA; each takes KB // WARPS keys a block


def num_splits(batch_kv_heads: int, span: int, sms: int) -> int:
    """Splits per (batch, KV head): as many as one wave of CTAs on ``sms``
    SMs holds, but no more than the longest span has blocks of KB keys
    (``span = min(S, window)``, or S without a window)."""
    return max(1, min(sms // max(batch_kv_heads, 1), -(-span // KB)))


def split_ranges(lengths, S: int, window: int, nsplit: int) -> np.ndarray:
    """(B, nsplit, 2) int64 ``[c0, c1)`` of each split; ``c1 == c0`` for
    an empty split."""
    out = np.zeros((len(lengths), nsplit, 2), dtype=np.int64)
    for b, length in enumerate(np.asarray(lengths, dtype=np.int64)):
        hi = min(int(length), S)
        lo = max(0, int(length) - window) if window > 0 else 0
        n = max(hi - lo, 0)
        nb = -(-(-(-n // KB)) // nsplit)  # blocks per split
        c0 = lo + np.arange(nsplit) * nb * KB
        out[b, :, 0] = c0
        out[b, :, 1] = np.maximum(c0, np.minimum(hi, c0 + nb * KB))
    return out


def _merge(acc, m, l, dim):
    """Partials (acc, m, l) merged along ``dim`` in index order."""
    M = m.max(dim=dim, keepdim=True).values
    c = torch.exp(m - M)
    A = sum(t.squeeze(dim) for t in (acc * c.unsqueeze(-1)).split(1, dim))
    L = sum(t.squeeze(dim) for t in (l * c).split(1, dim))
    return A, M.squeeze(dim), L


def tiled_ref(
    q: torch.Tensor,  # (B, H, d)
    k: torch.Tensor,  # (B, S, K, d)
    v: torch.Tensor,  # (B, S, K, d)
    lengths: torch.Tensor,  # (B,)
    *,
    window: int = 0,
    nsplit: int | None = None,
    sms: int = 132,
) -> torch.Tensor:
    """The kernel's algorithm; ``nsplit`` defaults to ``num_splits`` on a
    card of ``sms`` SMs."""
    B, H, d = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    if nsplit is None:
        nsplit = num_splits(B * K, min(S, window) if window else S, sms)
    scale = 1.0 / math.sqrt(d)
    ranges = torch.as_tensor(split_ranges(lengths.tolist(), S, window,
                                          nsplit))  # (B, n, 2)
    nb = int(-(-(ranges[..., 1] - ranges[..., 0]).max() // KB))
    kw = KB // WARPS
    qf = q.reshape(B, K, G, d).float()
    kf, vf = k.float(), v.float()
    acc = torch.zeros(B, K, nsplit, WARPS, G, d)
    m = torch.full((B, K, nsplit, WARPS, G), NEG_INF)
    l = torch.zeros(B, K, nsplit, WARPS, G)
    bidx = torch.arange(B)[:, None, None, None]
    for j in range(nb):
        # key slot of (batch, split, warp, lane key)
        pos = (ranges[..., 0][:, :, None, None] + j * KB
               + torch.arange(WARPS)[:, None] * kw + torch.arange(kw))
        ok = pos < ranges[..., 1][:, :, None, None]  # (B, n, W, kw)
        slot = pos.clamp(0, S - 1)
        kb = kf[bidx, slot]  # (B, n, W, kw, K, d)
        # V rows past a split's end zeroed, as the kernel does
        vb = torch.where(ok[..., None, None], vf[bidx, slot], 0.0)
        s = torch.einsum("bkgd,bnwjkd->bknwgj", qf, kb) * scale
        okb = ok[:, None, :, :, None, :]  # (B, 1, n, W, 1, kw)
        s = s.masked_fill(~okb, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None]).masked_fill(~okb, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bknwgj,bnwjkd->bknwgd",
                          p.to(v.dtype).float(), vb)
        acc = acc * corr[..., None] + pv
        m = m_new
    A, M, L = _merge(acc, m, l, dim=3)  # warps, in warp order
    A, _, L = _merge(A, M, L, dim=2)  # splits, in split order
    out = A / L.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, d).to(q.dtype)
