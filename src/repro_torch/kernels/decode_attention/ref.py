"""Plain PyTorch version of decode attention (counterpart of
``repro.kernels.decode_attention.ref``): one query token per sequence
against a cache, the G = H/K queries of a KV head grouped, slots
``pos < lengths[b]`` valid and, with a window, ``pos > lengths[b] - 1 -
window``; float32 logits, masked to -1e30, a full softmax, ``p`` cast to
``v``'s type before ``p.v``."""
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
    p = torch.softmax(logits, dim=-1).to(v.dtype).float()
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(B, H, d).to(q.dtype)
