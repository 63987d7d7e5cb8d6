"""The flash kernel's block schedule, checkable on the CPU.

``block_schedule`` gives each query block of ``bm`` rows the key blocks of
``bn`` keys that the wgmma kernel visits, ``[jb_lo, jb_hi)``, and the
sub-range ``[jf_lo, jf_hi)`` of blocks where every (row, key) pair is
visible, so that the kernel evaluates no mask there.  The formulas are the
kernel's (``csrc/flash_attention.cu``, ``flash_fwd_bf16_wgmma``).

``tiled_ref`` follows that schedule in plain PyTorch: online softmax in
float32 over the visited blocks, the mask applied on the edge blocks only,
``p`` rounded to ``v``'s type before ``p.v`` with ``l`` summed from the
unrounded ``p``, and the output ``acc / max(l, 1e-30)`` in q's type.  It
shows on the CPU that skipping the mask on the mask-free blocks, and the
blocks outside the range, changes nothing; the tests hold it against the
reference's Pallas kernel and ``mha_ref``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30


def block_schedule(Sq: int, Skv: int, *, causal: bool, window: int,
                   q_offset: int, bm: int = 128, bn: int = 128) -> np.ndarray:
    """(ceil(Sq / bm), 4) int64 rows ``(jb_lo, jb_hi, jf_lo, jf_hi)``.

    Visible pairs: key j < Skv and, with ``causal``, j <= i + q_offset and,
    with a window w > 0, j > i + q_offset - w.  A query block whose rows
    see no key gets an empty range (its rows come out 0)."""
    rows = []
    for m0 in range(0, Sq, bm):
        m1 = min(m0 + bm, Sq)
        kv_lo, kv_hi = 0, Skv
        if causal:
            kv_hi = min(Skv, m1 + q_offset)
            if window > 0:
                kv_lo = max(0, m0 + q_offset - window + 1)
        jb_lo = kv_lo // bn
        jb_hi = -(-kv_hi // bn) if kv_hi > kv_lo else jb_lo
        # every key of the block after the last row's window start, and at
        # or before the first row's causal limit, and below Skv
        jf_lo = (-(-max(0, m1 + q_offset - window) // bn)
                 if causal and window > 0 else 0)
        jf_hi = (min(Skv, m0 + q_offset + 1) if causal else Skv) // bn
        jf_lo = min(max(jf_lo, jb_lo), jb_hi)
        jf_hi = max(min(jf_hi, jb_hi), jf_lo)
        rows.append((jb_lo, jb_hi, jf_lo, jf_hi))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 4)


def _visible(qpos: torch.Tensor, kpos: torch.Tensor, Skv: int, *,
            causal: bool, window: int) -> torch.Tensor:
    """Mask of visible pairs for absolute query and key positions."""
    ok = (kpos < Skv)[None, :].expand(len(qpos), len(kpos))
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
        if window > 0:
            ok = ok & (kpos[None, :] > qpos[:, None] - window)
    return ok


def tiled_ref(
    q: torch.Tensor,  # (B, Sq, H, d)
    k: torch.Tensor,  # (B, Skv, K, d), K divides H
    v: torch.Tensor,  # (B, Skv, K, d)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    bm: int = 128,
    bn: int = 128,
) -> torch.Tensor:
    B, Sq, H, d = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(d)
    sched = block_schedule(Sq, Skv, causal=causal, window=window,
                           q_offset=q_offset, bm=bm, bn=bn)
    # keys zero-padded to whole blocks, as the kernel's TMA fills them
    pad = -(-Skv // bn) * bn - Skv
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    kf = kf.repeat_interleave(G, dim=2)
    vf = vf.repeat_interleave(G, dim=2)
    out = torch.empty_like(q)
    for qb, (jb_lo, jb_hi, jf_lo, jf_hi) in enumerate(sched):
        i0, i1 = qb * bm, min((qb + 1) * bm, Sq)
        qf = q[:, i0:i1].float()
        n = i1 - i0
        acc = torch.zeros(B, n, H, d)
        m = torch.full((B, n, H), NEG_INF)
        l = torch.zeros(B, n, H)
        qpos = torch.arange(i0, i1) + q_offset
        for j in range(int(jb_lo), int(jb_hi)):
            n0 = j * bn
            s = torch.einsum("bqhd,bkhd->bqhk", qf, kf[:, n0:n0 + bn]) * scale
            if not jf_lo <= j < jf_hi:  # an edge block: mask it
                ok = _visible(qpos, torch.arange(n0, n0 + bn), Skv,
                             causal=causal, window=window)
                s = s.masked_fill(~ok[None, :, None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bqhk,bkhd->bqhd", p.to(v.dtype).float(),
                              vf[:, n0:n0 + bn].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, i0:i1] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out
