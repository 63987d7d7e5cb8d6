"""Decoder-only transformer stack, dense family (counterpart of
``repro.models.transformer``).

The reference stores the layers stacked and runs them under ``lax.scan``;
here each layer is a module in an ``nn.ModuleList`` and the stack is a
loop.  A layer keeps the reference's parameter names (``ln1``, ``attn``,
``ln2``, ``mlp``) as ``nn.ParameterDict``s, so the layer functions take
them as the reference's take its dicts.

Two builds of :class:`DecoderLM`: for serving, matmul weights held in
``cfg.dtype`` with no gradient; trainable, every parameter a float32
master with ``requires_grad`` (the reference's ``param_dtype``), each
matmul weight cast to ``cfg.dtype`` at every use as the reference does.
Training runs each layer under the reference's remat policy
(``_remat``): ``none``, ``full`` (``torch.utils.checkpoint``) or
``dots`` (matmul outputs kept, the rest recomputed).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

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


def _param_dict(tensors: Dict[str, torch.Tensor],
                trainable: bool) -> nn.ParameterDict:
    return nn.ParameterDict({
        n: nn.Parameter(t, requires_grad=trainable)
        for n, t in tensors.items()})


class DecoderLayer(nn.Module):
    """One pre-norm layer: ``x + attn(ln1(x))``, then ``+ mlp(ln2(x))``."""

    def __init__(self, tensors: Dict[str, Dict[str, torch.Tensor]],
                 trainable: bool = False):
        super().__init__()
        self.ln1 = _param_dict(tensors["ln1"], trainable)
        self.attn = _param_dict(tensors["attn"], trainable)
        self.ln2 = _param_dict(tensors["ln2"], trainable)
        self.mlp = _param_dict(tensors["mlp"], trainable)


class DecoderLM(nn.Module):
    """Dense decoder LM: embedding, layers, final norm, LM head.  Built for
    serving, matmul weights are held in ``cfg.dtype`` with no gradient;
    embed, head and norms in float32, the values the reference computes
    with.  Built ``trainable``, every parameter is a float32 master that
    requires a gradient."""

    def __init__(self, cfg, embed: torch.Tensor, layers, ln_f, head,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.trainable = trainable
        self.embed = nn.Parameter(embed, requires_grad=trainable)
        self.layers = nn.ModuleList(DecoderLayer(t, trainable)
                                    for t in layers)
        self.ln_f = _param_dict(ln_f, trainable)
        self.head = (self.embed if head is None
                     else nn.Parameter(head, requires_grad=trainable))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def apply_layer(layer: DecoderLayer, x: torch.Tensor, cfg, *,
                positions: torch.Tensor, window: Optional[int],
                layer_cache: Optional[Dict[str, torch.Tensor]]):
    """One transformer layer.  Returns (x, updated layer cache; None
    without a cache)."""
    h = apply_norm(layer.ln1, x, cfg)
    a, layer_cache = attn.apply_attention(
        layer.attn, h, cfg, positions=positions, window=window,
        layer_cache=layer_cache, rope=(cfg.pos_embed == "rope"))
    x = x + a
    h = apply_norm(layer.ln2, x, cfg)
    x = x + apply_mlp(layer.mlp, h, cfg)
    return x, layer_cache


# the matmuls whose outputs ``remat="dots"`` keeps (the reference's
# ``checkpoint_dots_with_no_batch_dims``: x @ W, not the attention's
# batched products, which run inside the flash kernels)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg):
    """The reference's remat policy (``_remat``) around one layer."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _keep_dots)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def apply_stack(model: DecoderLM, x: torch.Tensor, *,
                positions: torch.Tensor, cache: Optional[Dict] = None):
    """Run the layers in order.  Serving: over a stacked cache
    (``init_cache``), which is updated in place.  Training (no cache):
    every layer under the config's remat policy (``_remat``).  Returns
    (x, cache)."""
    cfg = model.cfg
    window = cfg.sliding_window or None
    if cache is None:
        def one(layer, xc):
            return apply_layer(layer, xc, cfg, positions=positions,
                               window=window, layer_cache=None)[0]

        fn = _remat(one, cfg)
        for layer in model.layers:
            x = fn(layer, x)
        return x, None
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
