"""Whisper-style encoder-decoder (counterpart of ``repro.models.encdec``).

The audio frontend (two stride-2 convolutions over a mel spectrogram) is a
stub, as in the reference: the inputs are precomputed frame embeddings
(B, 1500, d_model).  Encoder: bidirectional self-attention layers
(``causal=False``).  Decoder: causal self-attention, then cross-attention
to the encoder's output, then the MLP.  Sinusoidal positions on both
sides.

Serving: ``models.model.prefill`` runs the encoder once, writes every
decoder layer's cross K/V into the serving cache (bfloat16, as the
reference stores them) and fills the decoder's self-attention cache;
``decode_step`` runs one token through the decoder over both.  A serving
model's parameters require no gradient, so its encoder records nothing
and runs without remat.

Training: ``models.model.forward_train`` runs the encoder under the
config's remat policy (the reference's ``encode`` runs ``mode="train"``),
keeps every decoder layer's cross K/V in ``cfg.dtype`` with autograd (the
reference's training does not round them to bfloat16), and runs the
decoder without a cache; the non-causal and cross-attention take their
gradient from the flash backward kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.dist.sharding import embed_lookup
from repro_torch.models import attention as attn
from repro_torch.models import transformer
from repro_torch.models.layers import (
    ParamDef, apply_norm, norm_schema, sinusoidal_positions, stacked)
from repro_torch.models.transformer import DecoderLayer, DecoderLM


def encdec_schema(cfg) -> Dict:
    """The reference's parameter tree: ``enc_groups.dense`` stacked over the
    encoder layers, ``enc_ln_f``, ``embed``, ``dec_groups.dense`` (with
    ``ln_x``, ``xattn``) stacked over the decoder layers, ``ln_f`` and an
    untied ``head``."""
    return {
        "enc_groups": stacked(transformer.group_schema(cfg, cross=False),
                              cfg.encoder_layers),
        "enc_ln_f": norm_schema(cfg),
        "embed": ParamDef((cfg.vocab_padded, cfg.d_model), ("vocab", "embed"),
                          "embed"),
        "dec_groups": stacked(transformer.group_schema(cfg, cross=True),
                              cfg.num_layers),
        "ln_f": norm_schema(cfg),
        "head": ParamDef((cfg.vocab_padded, cfg.d_model), ("vocab", "embed")),
    }


class EncDecLM(DecoderLM):
    """Encoder-decoder LM: the decoder as a :class:`DecoderLM` (embed, its
    layers with cross-attention, ``ln_f``, the head), plus the encoder
    layers (``enc_layers``) and the encoder's final norm
    (``enc_ln_f``)."""

    def __init__(self, cfg, embed: torch.Tensor, enc_layers, enc_ln_f,
                 layers, ln_f, head, trainable: bool = False):
        super().__init__(cfg, embed, layers, ln_f, head, trainable)
        self.enc_layers = nn.ModuleList(DecoderLayer(t, trainable)
                                        for t in enc_layers)
        self.enc_ln_f = nn.ParameterDict({
            n: nn.Parameter(t, requires_grad=trainable)
            for n, t in enc_ln_f.items()})


def encode(model: EncDecLM, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, d), already in ``cfg.dtype`` -> the encoder's hidden
    states (B, F, d): the float32 positions cast to the frames' type and
    added, the encoder layers without a mask (under the config's remat
    policy where autograd records), ``enc_ln_f``."""
    B, F, d = frames.shape
    pe = sinusoidal_positions(F, d, frames.device).to(frames.dtype)
    x = frames + pe[None]
    pos = torch.arange(F, device=frames.device)[None].expand(B, F)
    x, _, _ = transformer.apply_stack(model, x, positions=pos, causal=False,
                                      layers=model.enc_layers)
    return apply_norm(model.enc_ln_f, x, model.cfg)


def cross_kv_all_layers(model: EncDecLM, enc_out: torch.Tensor,
                        out: Optional[Tuple[torch.Tensor, torch.Tensor]]
                        = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross-attention K/V, stacked: (k, v), each
    (L, B, Se, H, hd), in ``enc_out``'s type with autograd (training), or
    written into ``out`` (the serving cache's ``cross`` pair, cast to its
    type) one layer at a time."""
    kvs = None if out is not None else ([], [])
    for i, layer in enumerate(model.layers):
        k, v = attn.make_cross_kv(layer.xattn, enc_out, model.cfg)
        if out is None:
            kvs[0].append(k)
            kvs[1].append(v)
        else:
            out[0][i].copy_(k)
            out[1][i].copy_(v)
    return out if out is not None else (torch.stack(kvs[0]),
                                        torch.stack(kvs[1]))


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Position rows computed from (B, S) positions (no table): float32
    (B, S, d)."""
    pos = positions.float()[..., None]
    dim = torch.arange(0, d, 2, dtype=torch.float32,
                       device=positions.device)[None, None, :]
    angle = pos / torch.pow(10_000.0, dim / d)
    pe = torch.zeros(positions.shape + (d,), dtype=torch.float32,
                     device=positions.device)
    pe[..., 0::2] = torch.sin(angle)
    pe[..., 1::2] = torch.cos(angle[..., : d // 2])
    return pe


def decoder_embed(model: EncDecLM, tokens: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """The float32 embedding plus the float32 position rows (the caller
    casts the sum to ``cfg.dtype``, as the reference's ``prefill`` and
    ``decode_step`` do)."""
    x = embed_lookup(model.embed, tokens)
    return x + sinusoidal_at(positions, model.cfg.d_model).to(x.dtype)


def decode_stack(model: EncDecLM, x: torch.Tensor, *,
                 positions: torch.Tensor, cross_kv,
                 cache: Optional[Dict] = None):
    """The decoder layers, causal, over the stacked cross K/V and the
    self-attention ``cache`` (serving; updated in place), or without a
    cache over the tokens' own K/V (training, positions ``arange(S)``,
    every layer under the config's remat policy)."""
    return transformer.apply_stack(model, x, positions=positions,
                                   cache=cache, cross_kv=cross_kv)


def init_encdec_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                      device="cuda") -> Dict:
    """``{"self": the decoder's KV cache (transformer.init_cache), "cross":
    (k, v)}``, each of the pair (L, B, Se, H, hd) in bfloat16, the type
    the reference's ``prefill`` stores them in whatever ``dtype`` is;
    ``prefill`` writes them."""
    H, hd = cfg.num_heads, cfg.head_dim
    shape = (cfg.num_layers, batch, cfg.encoder_seq_len, H, hd)
    self_cache = transformer.init_cache(cfg, batch, max_len, dtype, device)
    dev = self_cache["dense"]["k"].device
    cross = tuple(torch.zeros(shape, dtype=torch.bfloat16, device=dev)
                  for _ in range(2))
    return {"self": self_cache, "cross": cross}
