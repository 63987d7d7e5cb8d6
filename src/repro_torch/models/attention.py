"""GQA self-attention, with a KV cache (serving) or without (training),
and whisper's cross-attention, routed through the attention kernels
(counterpart of ``repro.models.attention``).

The reference computes attention with ``chunked_attention``, an
online-softmax jnp path over KV chunks that its docstring calls
mathematically identical to flash attention and the large-shape oracle of
its Pallas kernels.  Here ``chunked_attention`` stays as the plain oracle
on tensors, and serving and training run the kernels, which compute the
same function:

* prefill (``Sq > 1``): the new K/V go into the cache, then the flash
  kernel runs q (the new tokens) over cache slots ``[0, len + Sq)`` with
  ``q_offset = len``, causal, window ``cfg.sliding_window``;
* decode (``Sq == 1``): the new K/V go into the cache, then the decode
  kernel runs with ``lengths = len + 1``;
* training (no cache): :class:`FlashAttentionFn` runs the flash kernel
  over the layer's own K/V, causal, window ``cfg.sliding_window``, with
  its log-sum-exp, and its backward runs the flash backward kernel
  (``kernels/flash_attention/bwd.py``), the gradient the reference takes
  by differentiating ``chunked_attention``.  On CPU tensors both
  directions run the plain versions;
* non-causal, no cache (whisper's encoder, ``causal=False``):
  :class:`FlashAttentionFn` without the mask over the layer's own K/V,
  in serving and training alike; its backward runs the flash backward
  kernel without the mask;
* cross-attention (``cross_kv``, whisper's decoder): q over the encoder's
  K/V with no mask, MHA, through :class:`FlashAttentionFn` over K/V of
  their own length (Sq text tokens over Skv frames): in serving a
  prompt over the bfloat16 cross K/V that :func:`make_cross_kv` wrote
  into the cache once a prompt, in training the K/V in ``cfg.dtype``
  with their gradient.  Serving's one-token steps run the decode kernel
  instead, with every ``lengths`` the encoder length (its mask
  ``slot < length`` then keeps every slot).

The serving kernels take slot index as position, which holds in dense
serving: slot i holds the token at position i, and the reference masks
unwritten slots (``pos = -2^30``), which all lie at or past ``len``.
The reference's window test ``kpos > qpos - window`` is the decode
kernel's ``pos > length - 1 - window``.  Callers pass positions ``len + arange(Sq)`` (what
``models.model.prefill``/``decode_step`` do).

Unlike the reference, ``cache_update`` writes into the cache in place and
returns the same dict: serving needs no copy of a multi-GB cache per
token.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.superstep import resolve_device
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.flash_attention.bwd import flash_attention_bwd_cuda
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.models.layers import ParamDef, apply_rope

NEG_INF = -1e30
UNWRITTEN = -(2 ** 30)  # position stored in a cache slot never written


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, item {item})")


def attn_schema(cfg, cross: bool = False) -> Dict[str, ParamDef]:
    d, h = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    if cross:
        nkv = nh  # whisper cross-attention is MHA
    return {
        "wq": ParamDef((d, nh * h), ("embed", "heads")),
        "wk": ParamDef((d, nkv * h), ("embed", "kv_heads")),
        "wv": ParamDef((d, nkv * h), ("embed", "kv_heads")),
        "wo": ParamDef((nh * h, d), ("heads", "embed")),
    }


def _split_heads(x: torch.Tensor, n: int, h: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, h))


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, K, hd)
    v: torch.Tensor,  # (B, Skv, K, hd)
    *,
    q_positions: torch.Tensor,  # (B, Sq) absolute positions
    kv_positions: torch.Tensor,  # (B, Skv) absolute; invalid -> very negative
    kv_len: Optional[torch.Tensor] = None,  # (B,) valid cache length
    causal: bool = True,
    window: Optional[int] = None,  # None = unbounded
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks, the plain oracle.  Returns
    (B, Sq, H, hd).  The reference's ``prefix_len``, ``softcap`` and
    ``return_stats`` serve families and the tensor-parallel decode that are
    not ported (ROADMAP.md queue 1)."""
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    G = H // K
    chunk = min(chunk, Skv)
    pad = (-Skv) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=UNWRITTEN)
    n_chunks = (Skv + pad) // chunk

    qg = q.reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4).float()
    kc = k.permute(0, 2, 1, 3).reshape(B, K, n_chunks, chunk, hd)
    vc = v.permute(0, 2, 1, 3).reshape(B, K, n_chunks, chunk, hd)
    kpc = kv_positions.reshape(B, n_chunks, chunk)
    scale = 1.0 / math.sqrt(hd)
    qpos = q_positions[:, None, None, :, None]  # (B,1,1,Sq,1)

    acc = torch.zeros((B, K, G, Sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    for idx in range(n_chunks):
        kb, vb = kc[:, :, idx], vc[:, :, idx]  # (B,K,chunk,hd)
        kp = kpc[:, idx]  # (B,chunk)
        logits = torch.einsum("bkgsh,bkch->bkgsc", qg, kb.float()) * scale
        kpb = kp[:, None, None, None, :]  # (B,1,1,1,chunk)
        ok = kpb > -(2 ** 29)  # padded / unwritten slots masked out
        if kv_len is not None:
            slot = idx * chunk + torch.arange(chunk, device=q.device)
            ok = ok & (slot[None, None, None, None, :]
                       < kv_len[:, None, None, None, None])
        if causal:
            ok = ok & (kpb <= qpos)
            if window is not None:
                ok = ok & (kpb > qpos - window)
        logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgsc,bkch->bkgsh", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def init_kv_cache(cfg, batch: int, max_len: int, n_layers: int,
                  dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """Stacked (layers-leading) KV cache, as the reference's, on ``device``
    (the card unless the caller asks for the CPU)."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    device = resolve_device(device)
    return {
        "k": torch.zeros((n_layers, batch, max_len, K, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((n_layers, batch, max_len, K, hd), dtype=dtype,
                         device=device),
        # absolute position stored per slot; very negative = unwritten
        "pos": torch.full((n_layers, batch, max_len), UNWRITTEN,
                          dtype=torch.int32, device=device),
        "len": torch.zeros((n_layers, batch), dtype=torch.int32,
                           device=device),
    }


def cache_update(
    layer_cache: Dict[str, torch.Tensor],
    k_new: torch.Tensor,  # (B, S_new, K, hd)
    v_new: torch.Tensor,
    positions: torch.Tensor,  # (B, S_new)
    start: torch.Tensor,  # (B,) write offset (== current length)
) -> Dict[str, torch.Tensor]:
    """Write S_new entries at ``start`` (sequential layout, no ring), in
    place; returns ``layer_cache``.  Like the reference's
    ``dynamic_update_slice``, a start past the end is clamped so that the
    write fits.  One new token is scattered on the device (no host read);
    a longer write reads the B starts once."""
    ck, cv, cp, cl = (layer_cache[n] for n in ("k", "v", "pos", "len"))
    B, S_new = k_new.shape[:2]
    max_len = ck.shape[1]
    if S_new == 1:
        rows = torch.arange(B, device=ck.device)
        st = start.long().clamp(0, max_len - 1)
        ck[rows, st] = k_new[:, 0].to(ck.dtype)
        cv[rows, st] = v_new[:, 0].to(cv.dtype)
        cp[rows, st] = positions[:, 0].to(cp.dtype)
    else:
        for b, s in enumerate(start.tolist()):
            s = min(max(s, 0), max_len - S_new)
            ck[b, s:s + S_new] = k_new[b].to(ck.dtype)
            cv[b, s:s + S_new] = v_new[b].to(cv.dtype)
            cp[b, s:s + S_new] = positions[b].to(cp.dtype)
    cl += S_new
    return layer_cache


class FlashAttentionFn(torch.autograd.Function):
    """Attention of q over k/v with a gradient: the forward is the flash
    kernel with its log-sum-exp, the backward the flash backward kernel
    with the same mask.  q (B, Sq, H, d), k/v (B, Skv, K, d); with
    ``causal`` (the default) a causal, optionally windowed mask at
    positions ``arange(Sq)`` over ``arange(Skv)``, without it no mask
    (whisper's encoder, Sq = Skv, and cross-attention, Sq != Skv in
    general).  Returns (B, Sq, H, d)."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, causal: bool = True):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      q_offset=0, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.causal = window, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal=ctx.causal, window=ctx.window,
            q_offset=0)
        return dq, dk, dv, None, None


def _needs_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd records an op on ``ts`` (training)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def apply_attention(
    p,
    x: torch.Tensor,  # (B, Sq, d)
    cfg,
    *,
    positions: torch.Tensor,  # (B, Sq)
    layer_cache: Optional[Dict[str, torch.Tensor]],
    window: Optional[int] = None,
    rope: bool = True,
    causal: bool = True,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cross_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Self- or cross-attention through the attention kernels.  Causal
    self-attention over a KV cache (serving), or without one over the
    layer's own tokens (training; the caller passes positions
    ``arange(Sq)``, as ``models.model``'s ``forward_train`` does);
    non-causal self-attention without a cache (``causal=False``, whisper's
    encoder); cross-attention over ``cross_kv``, the encoder's (k, v),
    each (B, Se, H, hd) (whisper's decoder; ``layer_cache`` is then None,
    and ``cross_len``, the (B,) int32 encoder lengths for one-token
    decode, is made here when not given).  With no cache, the causal,
    non-causal and cross branches run :class:`FlashAttentionFn`, which
    has a gradient where autograd records (training); only serving's
    one-token steps run the decode kernel.  Returns (output (B, Sq, d),
    the updated layer cache, None without one).  Of the reference's
    options, the logit softcap, the bidirectional prefix and the
    tensor-parallel decode wait in ROADMAP.md queue 1."""
    if cfg.attn_logit_softcap > 0.0:
        raise _not_ported("attention logit softcap", "9: other LM families")
    B, Sq, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype

    q = _split_heads(x @ p["wq"].to(dt), H, hd)
    if rope:
        q = apply_rope(q, positions, cfg)
    if cross_kv is not None:
        # the reference's chunked_attention(q, k, v, causal=False) over
        # the stored cross K/V (bfloat16, whatever cfg.dtype is)
        k, v = cross_kv
        if Sq == 1 and not _needs_grad(q, k, v):  # serving's decode step
            if cross_len is None:
                cross_len = torch.full((B,), k.shape[1], dtype=torch.int32,
                                       device=q.device)
            out = decode_attention_cuda(q[:, 0], k, v, cross_len)[:, None]
        else:
            out = FlashAttentionFn.apply(q, k, v, 0, False)
        y = out.reshape(B, Sq, H * hd) @ p["wo"].to(dt)
        return y, None
    k = _split_heads(x @ p["wk"].to(dt), K, hd)
    v = _split_heads(x @ p["wv"].to(dt), K, hd)
    if rope:
        k = apply_rope(k, positions, cfg)
    win = int(window) if window is not None else 0
    if not causal:
        if layer_cache is not None or win:
            raise ValueError("non-causal attention takes no cache and no "
                             "window (whisper's encoder)")
        out = FlashAttentionFn.apply(q, k, v, 0, False)
    elif layer_cache is None:
        out = FlashAttentionFn.apply(q, k, v, win)
    elif Sq == 1:
        layer_cache = cache_update(layer_cache, k, v, positions,
                                   layer_cache["len"])
        kc, vc = layer_cache["k"], layer_cache["v"]
        if kc.dtype != dt:  # the reference reads the cache as ``dt``
            kc, vc = kc.to(dt), vc.to(dt)
        out = decode_attention_cuda(q[:, 0], kc, vc, layer_cache["len"],
                                    window=win)[:, None]
    else:
        lens = layer_cache["len"].tolist()
        if len(set(lens)) != 1:
            raise ValueError(f"prefill needs one cache length across the "
                             f"batch, got {lens}")
        start = lens[0]
        if start + Sq > layer_cache["k"].shape[1]:
            raise ValueError(f"prefill of {Sq} tokens after {start} overflows "
                             f"the cache of {layer_cache['k'].shape[1]} slots")
        layer_cache = cache_update(layer_cache, k, v, positions,
                                   layer_cache["len"])
        kc = layer_cache["k"][:, :start + Sq]
        vc = layer_cache["v"][:, :start + Sq]
        if kc.dtype != dt:
            kc, vc = kc.to(dt), vc.to(dt)
        out = flash_attention_cuda(q.contiguous(), kc, vc, causal=True,
                                   window=win, q_offset=start)
    y = out.reshape(B, Sq, H * hd) @ p["wo"].to(dt)
    return y, layer_cache


def make_cross_kv(p, enc_out: torch.Tensor, cfg
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's K/V for one decoder layer's cross-attention, computed
    once a prompt (whisper): each (B, Se, H, hd) in ``enc_out``'s type,
    MHA whatever ``cfg.num_kv_heads`` is (``attn_schema(cross=True)``)."""
    H, hd = cfg.num_heads, cfg.head_dim
    dt = enc_out.dtype
    k = _split_heads(enc_out @ p["wk"].to(dt), H, hd)
    v = _split_heads(enc_out @ p["wv"].to(dt), H, hd)
    return k, v
