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

``bwd_schedule`` does the same for the backward's wgmma route
(``csrc/flash_attention_bwd.cu``): for each block of ``kvb`` keys, the
query blocks of ``qs`` rows that the dK/dV kernel visits and the
sub-range that needs no mask; for each block of ``qr`` query rows, the
dQ kernel's key blocks of ``ks`` keys and their mask-free sub-range; and
both grids' launch order, the longest CTAs first.  ``tiled_bwd_ref``
follows it in plain PyTorch with the kernels' rounding points.
"""
from __future__ import annotations

import math
from typing import NamedTuple

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


class BwdSchedule(NamedTuple):
    """The backward kernels' blocks (``bwd_schedule``)."""

    #: (ceil(Skv / kvb), 4) rows ``(qb_lo, qb_hi, qf_lo, qf_hi)``: the
    #: query blocks a dK/dV CTA visits in each head, and the mask-free ones
    dkdv: np.ndarray
    #: (ceil(Sq / qr), 4) rows ``(jb_lo, jb_hi, jf_lo, jf_hi)`` of a dQ CTA
    dq: np.ndarray
    #: key blocks in launch order (the slowest grid index: first to last)
    dkdv_order: np.ndarray
    #: query blocks in launch order (last to first, as the forward's)
    dq_order: np.ndarray


def bwd_schedule(Sq: int, Skv: int, *, causal: bool, window: int,
                 q_offset: int, kvb: int = 128, qs: int = 64, qr: int = 128,
                 ks: int = 64) -> BwdSchedule:
    """The formulas of ``bwd_dkdv_bf16_wgmma`` and ``bwd_dq_bf16_wgmma``.

    A block is mask-free when every (row, key) pair in it is visible, its
    rows all below Sq and its keys all below Skv: rows past Sq and keys
    past Skv always take the mask.  A block whose rows see no key of the
    other side is not visited; an empty range leaves zeros."""
    dkdv = []
    for n0 in range(0, Skv, kvb):
        n1 = min(n0 + kvb, Skv)
        i_lo, i_hi = 0, Sq
        if causal:
            i_lo = max(0, n0 - q_offset)
            if window > 0:
                i_hi = min(Sq, n1 - 1 - q_offset + window)
        qb_lo = i_lo // qs
        qb_hi = -(-i_hi // qs) if i_hi > i_lo else qb_lo
        # every row at or after the last key's causal limit and before the
        # first key's window end, whole blocks of rows and keys
        qf_lo = -(-max(0, n0 + kvb - 1 - q_offset) // qs) if causal else 0
        qf_hi = (max(0, min(Sq, n0 - q_offset + window))
                 if causal and window > 0 else Sq) // qs
        if n0 + kvb > Skv:
            qf_hi = qf_lo
        qf_lo = min(max(qf_lo, qb_lo), qb_hi)
        qf_hi = max(min(qf_hi, qb_hi), qf_lo)
        dkdv.append((qb_lo, qb_hi, qf_lo, qf_hi))
    dq = block_schedule(Sq, Skv, causal=causal, window=window,
                        q_offset=q_offset, bm=qr, bn=ks)
    for qb in range(len(dq)):  # a ragged last query block takes the mask
        if (qb + 1) * qr > Sq:
            dq[qb, 3] = dq[qb, 2]
    nkb = len(dkdv)
    return BwdSchedule(np.asarray(dkdv, dtype=np.int64).reshape(-1, 4), dq,
                       np.arange(nkb), np.arange(len(dq))[::-1].copy())


def tiled_bwd_ref(
    q: torch.Tensor,  # (B, Sq, H, d)
    k: torch.Tensor,  # (B, Skv, K, d), K divides H
    v: torch.Tensor,  # (B, Skv, K, d)
    o: torch.Tensor,  # (B, Sq, H, d), the forward's output
    lse: torch.Tensor,  # (B, H, Sq) float32, the forward's log-sum-exp
    do: torch.Tensor,  # (B, Sq, H, d)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    kvb: int = 128,
    qs: int = 64,
    qr: int = 128,
    ks: int = 64,
):
    """(dq, dk, dv) in the inputs' types, as the wgmma route computes
    them: the blocks of :func:`bwd_schedule` (the mask on edge blocks
    only; rows and keys zero-padded to whole blocks, as TMA fills them,
    with lse and D 0 there), float32 products of the inputs' values, P and
    dS rounded to q's type before the products they feed (P only in dV,
    as dQ's S is recomputed unrounded), dK and dV summed over the G heads
    of a group and each head's query blocks in order, dQ over key blocks
    in order, dK and dQ scaled at the end."""
    B, Sq, H, d = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(d)
    sch = bwd_schedule(Sq, Skv, causal=causal, window=window,
                       q_offset=q_offset, kvb=kvb, qs=qs, qr=qr, ks=ks)

    def rnd(x):
        return x.to(q.dtype).float()

    def pad_rows(x, n, dim):
        shape = list(x.shape)
        shape[dim] = n - shape[dim]
        return torch.cat([x, x.new_zeros(shape)], dim=dim)

    sqp = max(-(-Sq // m) * m for m in (qs, qr))
    skp = max(-(-Skv // m) * m for m in (kvb, ks))
    dd = (do.float() * o.float()).sum(-1).permute(0, 2, 1)  # (B, H, Sq)
    qf, dof = (pad_rows(t.float(), sqp, 1) for t in (q, do))
    lp, dp_ = (pad_rows(t.float(), sqp, 2) for t in (lse, dd))
    kf, vf = (pad_rows(t.float(), skp, 1) for t in (k, v))

    def mask(rows, keys):
        return _visible(rows + q_offset, keys, Skv, causal=causal,
                        window=window) & (rows < Sq)[:, None]

    dk = torch.zeros(B, skp, K, d)
    dv = torch.zeros(B, skp, K, d)
    for kb, (qb_lo, qb_hi, qf_lo, qf_hi) in enumerate(sch.dkdv):
        n0 = kb * kvb
        kt, vt = kf[:, n0:n0 + kvb], vf[:, n0:n0 + kvb]
        keys = torch.arange(n0, n0 + kvb)
        for gg in range(G):
            hs = torch.arange(K) * G + gg  # head gg of each group
            for qb in range(int(qb_lo), int(qb_hi)):
                m0 = qb * qs
                qt, ot = qf[:, m0:m0 + qs, hs], dof[:, m0:m0 + qs, hs]
                lt, dt = lp[:, hs, m0:m0 + qs], dp_[:, hs, m0:m0 + qs]
                st = torch.einsum("bjkd,bikd->bkji", kt, qt) * scale
                p = torch.exp(st - lt[:, :, None, :])
                if not qf_lo <= qb < qf_hi:
                    ok = mask(torch.arange(m0, m0 + qs), keys).T
                    p = torch.where(ok, p, torch.zeros(()))
                dpt = torch.einsum("bjkd,bikd->bkji", vt, ot)
                ds = p * (dpt - dt[:, :, None, :])
                dv[:, n0:n0 + kvb] += torch.einsum("bkji,bikd->bjkd",
                                                   rnd(p), ot)
                dk[:, n0:n0 + kvb] += torch.einsum("bkji,bikd->bjkd",
                                                   rnd(ds), qt)
    kg, vg = (t.repeat_interleave(G, dim=2) for t in (kf, vf))
    dq = torch.zeros(B, sqp, H, d)
    for qb, (jb_lo, jb_hi, jf_lo, jf_hi) in enumerate(sch.dq):
        m0 = qb * qr
        qt, ot = qf[:, m0:m0 + qr], dof[:, m0:m0 + qr]
        lt, dt = lp[:, :, m0:m0 + qr], dp_[:, :, m0:m0 + qr]
        rows = torch.arange(m0, m0 + qr)
        for j in range(int(jb_lo), int(jb_hi)):
            n0 = j * ks
            kt, vt = kg[:, n0:n0 + ks], vg[:, n0:n0 + ks]
            s = torch.einsum("bihd,bjhd->bhij", qt, kt) * scale
            p = torch.exp(s - lt[..., None])
            if not jf_lo <= j < jf_hi:
                ok = mask(rows, torch.arange(n0, n0 + ks))
                p = torch.where(ok, p, torch.zeros(()))
            dp = torch.einsum("bihd,bjhd->bhij", ot, vt)
            ds = p * (dp - dt[..., None])
            dq[:, m0:m0 + qr] += torch.einsum("bhij,bjhd->bihd", rnd(ds), kt)
    return ((dq[:, :Sq] * scale).to(q.dtype),
            (dk[:, :Skv] * scale).to(k.dtype), dv[:, :Skv].to(v.dtype))
