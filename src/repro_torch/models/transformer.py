"""Decoder-only transformer stack, dense family (counterpart of
``repro.models.transformer``).

The reference stores the layers stacked and runs them under ``lax.scan``;
here each layer is a module in an ``nn.ModuleList`` and the stack is a
loop.  A layer keeps the reference's parameter names (``ln1``, ``attn``,
``ln2``, ``mlp``) as ``nn.ParameterDict``s, so the layer functions take
them as the reference's take its dicts.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    ParamDef, apply_mlp, apply_norm, mlp_schema, norm_schema, stacked)


def layer_schema(cfg) -> Dict:
    return {
        "ln1": norm_schema(cfg),
        "attn": attn.attn_schema(cfg),
        "ln2": norm_schema(cfg),
        "mlp": mlp_schema(cfg),
    }


def decoder_schema(cfg) -> Dict:
    """The reference's parameter tree for a dense decoder: the layer
    schema stacked under ``groups.dense``."""
    sch = {
        "embed": ParamDef((cfg.vocab_padded, cfg.d_model), ("vocab", "embed"),
                          "embed"),
        "groups": {"dense": stacked(layer_schema(cfg), cfg.num_layers)},
        "ln_f": norm_schema(cfg),
    }
    if not cfg.tie_embeddings:
        sch["head"] = ParamDef((cfg.vocab_padded, cfg.d_model),
                               ("vocab", "embed"))
    return sch


def _param_dict(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({
        n: nn.Parameter(t, requires_grad=False) for n, t in tensors.items()})


class DecoderLayer(nn.Module):
    """One pre-norm layer: ``x + attn(ln1(x))``, then ``+ mlp(ln2(x))``."""

    def __init__(self, tensors: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        self.ln1 = _param_dict(tensors["ln1"])
        self.attn = _param_dict(tensors["attn"])
        self.ln2 = _param_dict(tensors["ln2"])
        self.mlp = _param_dict(tensors["mlp"])


class DecoderLM(nn.Module):
    """Dense decoder LM: embedding, layers, final norm, LM head.  Matmul
    weights are held in ``cfg.dtype``; embed, head and norms in float32,
    the values the reference computes with."""

    def __init__(self, cfg, embed: torch.Tensor, layers, ln_f, head):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(DecoderLayer(t) for t in layers)
        self.ln_f = _param_dict(ln_f)
        self.head = (self.embed if head is None
                     else nn.Parameter(head, requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def apply_layer(layer: DecoderLayer, x: torch.Tensor, cfg, *,
                positions: torch.Tensor, window: Optional[int],
                layer_cache: Dict[str, torch.Tensor]):
    """One transformer layer.  Returns (x, updated layer cache)."""
    h = apply_norm(layer.ln1, x, cfg)
    a, layer_cache = attn.apply_attention(
        layer.attn, h, cfg, positions=positions, window=window,
        layer_cache=layer_cache, rope=(cfg.pos_embed == "rope"))
    x = x + a
    h = apply_norm(layer.ln2, x, cfg)
    x = x + apply_mlp(layer.mlp, h, cfg)
    return x, layer_cache


def apply_stack(model: DecoderLM, x: torch.Tensor, *,
                positions: torch.Tensor, cache: Dict):
    """Run the layers in order over a stacked cache (``init_cache``),
    which is updated in place.  Returns (x, cache)."""
    cfg = model.cfg
    window = cfg.sliding_window or None
    c = cache["dense"]
    for i, layer in enumerate(model.layers):
        layer_cache = {n: t[i] for n, t in c.items()}
        x, _ = apply_layer(layer, x, cfg, positions=positions, window=window,
                           layer_cache=layer_cache)
    return x, cache


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> Dict:
    """KV cache stacked over the layers, nested as the reference's dense
    cache (``{"dense": {k, v, pos, len}}``), on the card unless the caller
    asks for the CPU."""
    return {"dense": attn.init_kv_cache(cfg, batch, max_len, cfg.num_layers,
                                        dtype, device)}
