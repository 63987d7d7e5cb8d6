"""Plain PyTorch version of flash attention (counterpart of
``repro.kernels.flash_attention.ref``).

``mha_ref`` computes what the reference's ``mha_ref`` computes: float32
logits ``q.k / sqrt(d)``, the causal and window masks from absolute
positions set to -1e30, a full softmax.  Two differences of form, none of
value: k/v may keep fewer heads than q (query head h reads KV head h // G,
where the reference expands them first), and the queries go in chunks
whose keys are restricted to those the mask lets any row of the chunk
see, so that the logits of a long prompt never exist all at once.  Where
``v`` is narrower than float32, ``p`` is rounded to ``v``'s type before
``p.v`` as the kernels and the reference's model path
(``chunked_attention``) round it: unnormalised, ``exp(s - max s)``, the
row sum taken in float32 and divided out after the product.  (The
reference's ``mha_ref`` rounds the normalised ``p``; the two differ by
rounding only, and in float32 not at all beyond it.)

``mha_bwd_ref`` is the plain version of the backward kernel
(``bwd.py``): the explicit gradient formula in float32, recomputing the
probabilities from the forward's log-sum-exp.
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
    return_lse: bool = False,
):
    """Returns ``(B, Sq, H, d)`` in q's type, and with ``return_lse`` also
    the float32 ``(B, H, Sq)`` log-sum-exp of each row's scaled, masked
    logits (-inf for a row that sees no key, as the kernel gives)."""
    B, Sq, H, d = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = (torch.empty((B, K, G, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
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
        if return_lse:
            lc = torch.logsumexp(logits, dim=-1)
            if causal:
                lc = lc.masked_fill(~ok.any(dim=-1), float("-inf"))
            lse[..., i0:i1] = lc
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        o = torch.einsum("bkgqs,bskd->bqkgd", e.to(v.dtype).float(),
                         vc.float())
        o = o / e.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
        out[:, i0:i1] = o.reshape(B, i1 - i0, H, d).to(q.dtype)
    if return_lse:
        return out, lse.reshape(B, H, Sq)
    return out


def mha_bwd_ref(
    q: torch.Tensor,  # (B, Sq, H, d)
    k: torch.Tensor,  # (B, Skv, K, d)
    v: torch.Tensor,  # (B, Skv, K, d)
    o: torch.Tensor,  # (B, Sq, H, d), the forward's output
    lse: torch.Tensor,  # (B, H, Sq) float32, the forward's log-sum-exp
    do: torch.Tensor,  # (B, Sq, H, d), the output's gradient
    *,
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
    chunk: int = 512,
):
    """Plain version of the flash backward: (dq, dk, dv) in the inputs'
    types, computed in float32 by the explicit formula (not autograd)::

        P  = exp(q k^T / sqrt(d) - lse)   on the pairs the mask allows
        D  = rowsum(dO o)
        dV = P^T dO,   dS = P (dO v^T - D)
        dQ = dS k / sqrt(d),   dK = dS^T q / sqrt(d)

    Query head h reads KV head h // G, and dK, dV sum over the G heads of
    a group.  The queries go in chunks, and each chunk's keys are cut to
    those the mask lets any of its rows see, as in :func:`mha_ref`.  It is
    the gradient that autodiff of the reference's ``chunked_attention``
    gives wherever every row sees a key (every causal row sees itself).
    """
    B, Sq, H, d = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(d)
    kf, vf = k.float(), v.float()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    lse_g = lse.reshape(B, K, G, Sq)
    for i0 in range(0, Sq, chunk):
        i1 = min(Sq, i0 + chunk)
        lo, hi = 0, Skv
        if causal:
            hi = max(0, min(Skv, i1 + q_offset))
            if window:
                lo = min(hi, max(0, i0 + q_offset - window + 1))
        n = i1 - i0
        qc = q[:, i0:i1].reshape(B, n, K, G, d).float()
        oc = o[:, i0:i1].reshape(B, n, K, G, d).float()
        doc = do[:, i0:i1].reshape(B, n, K, G, d).float()
        kc, vc = kf[:, lo:hi], vf[:, lo:hi]
        s = torch.einsum("bqkgd,bskd->bkgqs", qc, kc) * scale
        ok = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
        if causal:
            qpos = torch.arange(i0, i1, device=q.device)[:, None] + q_offset
            kpos = torch.arange(lo, hi, device=q.device)[None, :]
            ok = kpos <= qpos
            if window:
                ok &= kpos > qpos - window
        p = torch.exp(s - lse_g[..., i0:i1, None]).masked_fill(~ok, 0.0)
        dp = torch.einsum("bqkgd,bskd->bkgqs", doc, vc)
        dd = (doc * oc).sum(-1).permute(0, 2, 3, 1)  # (B, K, G, n)
        ds = p * (dp - dd[..., None])
        dq[:, i0:i1] = (torch.einsum("bkgqs,bskd->bqkgd", ds, kc)
                        * scale).reshape(B, n, H, d)
        dk[:, lo:hi] += torch.einsum("bkgqs,bqkgd->bskd", ds, qc) * scale
        dv[:, lo:hi] += torch.einsum("bkgqs,bqkgd->bskd", p, doc)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
