"""Plain PyTorch version of flash attention (counterpart of
``repro.kernels.flash_attention.ref``).

``mha_ref`` computes what the reference's ``mha_ref`` computes: float32
logits ``q.k / sqrt(d)``, the causal and window masks from absolute
positions set to -1e30, a full softmax, ``p`` cast to ``v``'s type before
``p.v``.  Two differences of form, none of value: k/v may keep fewer heads
than q (query head h reads KV head h // G, where the reference expands
them first), and the queries go in chunks whose keys are restricted to
those the mask lets any row of the chunk see, so that the logits of a
long prompt never exist all at once.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def mha_ref(
    q: torch.Tensor,  # (B, Sq, H, d)
    k: torch.Tensor,  # (B, Skv, K, d), K divides H
    v: torch.Tensor,  # (B, Skv, K, d)
    *,
    causal: bool = True,
    q_offset: int = 0,  # absolute position of q[:, 0]
    window: int = 0,  # sliding window; 0 = unbounded
    chunk: int = 512,
) -> torch.Tensor:
    B, Sq, H, d = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    for i0 in range(0, Sq, chunk):
        i1 = min(Sq, i0 + chunk)
        lo, hi = 0, Skv
        last = i1 - 1 + q_offset
        # keys no row of the chunk can see; a row that sees none keeps the
        # reference's uniform average over all keys, so then keep them all
        if causal and not (window and last >= Skv + window - 1):
            hi = min(Skv, last + 1)
            if window:
                lo = max(0, i0 + q_offset - window + 1)
        qc = q[:, i0:i1].reshape(B, i1 - i0, K, G, d).float()
        kc, vc = k[:, lo:hi].float(), v[:, lo:hi]
        logits = torch.einsum("bqkgd,bskd->bkgqs", qc, kc) * scale
        if causal:
            qpos = torch.arange(i0, i1, device=q.device)[:, None] + q_offset
            kpos = torch.arange(lo, hi, device=q.device)[None, :]
            ok = kpos <= qpos
            if window:
                ok &= kpos > qpos - window
            logits = logits.masked_fill(~ok, NEG_INF)
        p = torch.softmax(logits, dim=-1).to(v.dtype).float()
        o = torch.einsum("bkgqs,bskd->bqkgd", p, vc.float())
        out[:, i0:i1] = o.reshape(B, i1 - i0, H, d).to(q.dtype)
    return out
