"""Plain PyTorch version of decode attention (counterpart of
``repro.kernels.decode_attention.ref``): one query token per sequence
against a cache, the G = H/K queries of a KV head grouped, slots
``pos < lengths[b]`` valid and, with a window, ``pos > lengths[b] - 1 -
window``; float32 logits, masked to -1e30, a full softmax.  Where ``v``
is narrower than float32, ``p`` is rounded to ``v``'s type before ``p.v``
as the kernel and the reference's ``chunked_attention`` round it:
unnormalised, ``exp(s - max s)``, the row sum divided out after the
product (the reference's ``decode_ref`` rounds the normalised ``p``, which
differs by rounding only)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_ref(
    q: torch.Tensor,  # (B, H, d) one new token per sequence
    k: torch.Tensor,  # (B, S, K, d) cache
    v: torch.Tensor,  # (B, S, K, d)
    lengths: torch.Tensor,  # (B,) valid cache entries
    *,
    window: int = 0,  # sliding window over absolute positions; 0 = unbounded
) -> torch.Tensor:
    B, H, d = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(B, K, G, d).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    pos = torch.arange(S, device=q.device)[None]  # (1, S)
    lens = lengths.to(q.device)[:, None]
    ok = pos < lens
    if window:
        ok &= pos > (lens - 1 - window)
    logits = logits.masked_fill(~ok[:, None, None, :], NEG_INF)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgs,bskd->bkgd", e.to(v.dtype).float(), v.float())
    out = out / e.sum(dim=-1)[..., None]
    return out.reshape(B, H, d).to(q.dtype)
