"""Transformer layer stack, dense and MoE families, and the layers of
whisper's encoder and decoder (counterpart of
``repro.models.transformer``).

The reference stores the layers stacked and runs them under ``lax.scan``,
the MoE family over groups of ``moe_every - 1`` dense layers and one MoE
layer; here each layer is a module in an ``nn.ModuleList``, in the order
they run (:func:`layer_slots`), and the stack is a loop.  A layer keeps
the reference's parameter names (``ln1``, ``attn``, ``ln2``, ``mlp`` or
``moe``, and a decoder layer of whisper's ``ln_x``, ``xattn``) as
``nn.ParameterDict``s, so the layer functions take them as the
reference's take its dicts.

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
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    ParamDef, apply_mlp, apply_norm, mlp_schema, norm_schema, stacked)


def layer_schema(cfg, *, kind: str = "dense", cross: bool = False) -> Dict:
    sch = {
        "ln1": norm_schema(cfg),
        "attn": attn.attn_schema(cfg),
        "ln2": norm_schema(cfg),
    }
    if kind == "moe":
        sch["moe"] = moe_mod.moe_schema(cfg)
    else:
        sch["mlp"] = mlp_schema(cfg)
    if cross:
        sch["ln_x"] = norm_schema(cfg)
        sch["xattn"] = attn.attn_schema(cfg, cross=True)
    return sch


def _group_structure(cfg) -> Tuple[int, int, bool]:
    """(n_groups, dense layers per group, has_moe): the MoE family runs
    groups of ``moe_every - 1`` dense layers and one MoE layer; the dense
    family one layer a group."""
    if cfg.is_moe:
        ge = cfg.moe.moe_every
        if cfg.num_layers % ge:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                             f"groups of moe_every = {ge}")
        return cfg.num_layers // ge, ge - 1, True
    return cfg.num_layers, 1, False


def group_schema(cfg, *, cross: bool = False) -> Dict:
    _, n_dense, has_moe = _group_structure(cfg)
    if not has_moe:
        return {"dense": layer_schema(cfg, kind="dense", cross=cross)}
    sch = {"moe": layer_schema(cfg, kind="moe")}
    if n_dense:
        sch["dense"] = stacked(layer_schema(cfg, kind="dense"), n_dense)
    return sch


def decoder_schema(cfg) -> Dict:
    """The reference's parameter tree for a decoder: the group schema
    stacked over the groups under ``groups`` (dense family:
    ``groups.dense`` stacked over the layers; MoE family: ``groups.moe``
    over the groups and ``groups.dense`` over (groups, moe_every - 1))."""
    n_groups, _, _ = _group_structure(cfg)
    sch = {
        "embed": ParamDef((cfg.vocab_padded, cfg.d_model), ("vocab", "embed"),
                          "embed"),
        "groups": stacked(group_schema(cfg), n_groups),
        "ln_f": norm_schema(cfg),
    }
    if not cfg.tie_embeddings:
        sch["head"] = ParamDef((cfg.vocab_padded, cfg.d_model),
                               ("vocab", "embed"))
    return sch


def layer_slots(cfg) -> List[Tuple[str, Tuple[int, ...]]]:
    """The layers in the order they run, each as (kind, its index in the
    reference's stacked tree ``groups.<kind>``): the dense family's layer
    i is ``("dense", (i,))``; in the MoE family, group g runs its dense
    layers ``("dense", (g, j))`` first and its MoE layer ``("moe", (g,))``
    last, so llama4's layer 0 is dense and layer 1 MoE."""
    n_groups, n_dense, has_moe = _group_structure(cfg)
    if not has_moe:
        return [("dense", (i,)) for i in range(n_groups)]
    out = []
    for g in range(n_groups):
        out += [("dense", (g, j)) for j in range(n_dense)]
        out.append(("moe", (g,)))
    return out


def _param_dict(tensors: Dict[str, torch.Tensor],
                trainable: bool) -> nn.ParameterDict:
    return nn.ParameterDict({
        n: nn.Parameter(t, requires_grad=trainable)
        for n, t in tensors.items()})


class DecoderLayer(nn.Module):
    """One pre-norm layer: ``x + attn(ln1(x))``, with cross-attention
    (``xattn``, whisper's decoder) ``+ xattn(ln_x(x))``, then ``+
    mlp(ln2(x))``, or ``+ moe(ln2(x))`` for a MoE layer (``kind``)."""

    def __init__(self, tensors: Dict[str, Dict[str, torch.Tensor]],
                 trainable: bool = False):
        super().__init__()
        self.kind = "moe" if "moe" in tensors else "dense"
        self.ln1 = _param_dict(tensors["ln1"], trainable)
        self.attn = _param_dict(tensors["attn"], trainable)
        self.ln2 = _param_dict(tensors["ln2"], trainable)
        if self.kind == "moe":
            self.moe = _param_dict(tensors["moe"], trainable)
        else:
            self.mlp = _param_dict(tensors["mlp"], trainable)
        self.cross = "xattn" in tensors
        if self.cross:
            self.ln_x = _param_dict(tensors["ln_x"], trainable)
            self.xattn = _param_dict(tensors["xattn"], trainable)


class DecoderLM(nn.Module):
    """Decoder LM: embedding, layers (in the order they run,
    :func:`layer_slots`), final norm, LM head.  Built for serving, matmul
    weights are held in ``cfg.dtype`` with no gradient; embed, head, norms
    and the MoE router in float32, the values the reference computes with.
    Built ``trainable``, every parameter is a float32 master that requires
    a gradient."""

    def __init__(self, cfg, embed: torch.Tensor, layers, ln_f, head,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.trainable = trainable
        self.slots = layer_slots(cfg)
        self.embed = nn.Parameter(embed, requires_grad=trainable)
        self.layers = nn.ModuleList(DecoderLayer(t, trainable)
                                    for t in layers)
        self.ln_f = _param_dict(ln_f, trainable)
        self.head = (self.embed if head is None
                     else nn.Parameter(head, requires_grad=trainable))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def stacked_layers(self, kind: str) -> List[DecoderLayer]:
        """The layers of one kind in the row-major order of their stacked
        leaves in the reference's tree (``groups.<kind>``)."""
        return [layer for layer, (k, _) in zip(self.layers, self.slots)
                if k == kind]


def apply_layer(layer: DecoderLayer, x: torch.Tensor, cfg, *,
                positions: torch.Tensor, window: Optional[int],
                layer_cache: Optional[Dict[str, torch.Tensor]],
                causal: bool = True, cross_kv=None, cross_len=None):
    """One transformer layer; with ``cross_kv`` (the encoder's (k, v) for
    this layer) the cross-attention step after self-attention.  Returns
    (x, updated layer cache (None without a cache), a MoE layer's aux loss
    (float32 scalar) in training; None for a dense layer and under a
    cache, where serving would discard it, so that neither adds a
    launch)."""
    h = apply_norm(layer.ln1, x, cfg)
    a, layer_cache = attn.apply_attention(
        layer.attn, h, cfg, positions=positions, window=window,
        layer_cache=layer_cache, rope=(cfg.pos_embed == "rope"),
        causal=causal)
    x = x + a
    if cross_kv is not None:
        hx = apply_norm(layer.ln_x, x, cfg)
        c, _ = attn.apply_attention(
            layer.xattn, hx, cfg, positions=positions, layer_cache=None,
            rope=False, cross_kv=cross_kv, cross_len=cross_len)
        x = x + c
    h = apply_norm(layer.ln2, x, cfg)
    if layer.kind == "moe":
        m, aux = moe_mod.moe_apply(layer.moe, h, cfg,
                                   with_aux=layer_cache is None)
    else:
        m, aux = apply_mlp(layer.mlp, h, cfg), None
    return x + m, layer_cache, aux


# the matmuls whose outputs ``remat="dots"`` keeps (the reference's
# ``checkpoint_dots_with_no_batch_dims``: x @ W, not the attention's
# batched products, which run inside the flash kernels, nor the MoE
# experts' ``bmm``s, whose expert axis is a batch dimension)
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
                positions: torch.Tensor, cache: Optional[Dict] = None,
                causal: bool = True, cross_kv=None, layers=None):
    """Run the layers in order (:func:`layer_slots`), with ``cross_kv``
    (whisper's decoder) over the encoder's (k, v) stacked over the layers,
    each (L, B, Se, H, hd).  Serving: over a cache nested as the
    reference's (``init_cache``), updated in place.  Without a cache
    (training, or ``layers=model.enc_layers`` with ``causal=False``,
    whisper's encoder, in training and serving alike), every layer under
    the config's remat policy (``_remat``) where autograd records: the
    model is trainable, or ``x`` requires a gradient.  So a serving
    model's encoder runs plain and records nothing.  Returns (x, cache,
    the layers' summed aux loss); the aux loss only without a cache (None
    with one: serving discards it)."""
    cfg = model.cfg
    window = cfg.sliding_window or None
    if cache is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def one(layer, xc, *kv):
            y, _, a = apply_layer(layer, xc, cfg, positions=positions,
                                  window=window, layer_cache=None,
                                  causal=causal, cross_kv=kv or None)
            return y, a

        records = torch.is_grad_enabled() and (model.trainable
                                               or x.requires_grad)
        fn = _remat(one, cfg) if records else one
        run = model.layers if layers is None else layers
        # one unbind a side: its backward stacks the layers' gradients once
        kvs = ([()] * len(run) if cross_kv is None else
               list(zip(cross_kv[0].unbind(0), cross_kv[1].unbind(0))))
        for layer, kv in zip(run, kvs):
            x, a = fn(layer, x, *kv)
            if a is not None:
                aux = aux + a
        return x, None, aux
    cross_len = None
    if cross_kv is not None and x.shape[1] == 1:  # decode: all Se slots
        B, Se = cross_kv[0].shape[1:3]
        cross_len = torch.full((B,), Se, dtype=torch.int32, device=x.device)
    for layer, (kind, idx) in zip(model.layers, model.slots):
        layer_cache = {n: t[idx] for n, t in cache[kind].items()}
        lcross = (None if cross_kv is None
                  else (cross_kv[0][idx], cross_kv[1][idx]))
        x, _, _ = apply_layer(layer, x, cfg, positions=positions,
                              window=window, layer_cache=layer_cache,
                              causal=causal, cross_kv=lcross,
                              cross_len=cross_len)
    return x, cache, None


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> Dict:
    """KV cache nested as the reference's: ``{"dense": {k, v, pos, len}}``
    stacked over the layers for the dense family; ``{"moe": (groups, ...),
    "dense": (groups, moe_every - 1, ...)}`` for the MoE family.  On the
    card unless the caller asks for the CPU."""
    n_groups, n_dense, has_moe = _group_structure(cfg)
    if not has_moe:
        return {"dense": attn.init_kv_cache(cfg, batch, max_len, n_groups,
                                            dtype, device)}
    cache = {"moe": attn.init_kv_cache(cfg, batch, max_len, n_groups, dtype,
                                       device)}
    if n_dense:
        c = attn.init_kv_cache(cfg, batch, max_len, n_groups * n_dense,
                               dtype, device)
        cache["dense"] = {n: t.view((n_groups, n_dense) + t.shape[1:])
                          for n, t in c.items()}
    return cache
