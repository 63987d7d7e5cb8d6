"""Dense LM serving: parameters, cache, prefill and decode (counterpart of
``repro.models.model``, dense family).

Public surface:
  model_schema(cfg)                        -> the reference's param schema
  init_model_params(cfg, generator, device) -> DecoderLM, random weights
  params_from_numpy(tree, cfg, device)     -> DecoderLM from the reference's
                                              parameter tree (numpy)
  init_serve_cache(cfg, batch, max_len, dtype, device) -> KV cache
  prefill(model, batch)                    -> (last-token logits, cache)
  decode_step(model, batch)                -> (logits, cache)

The reference keeps float32 parameters and casts each matmul weight to
``cfg.dtype`` at every use (``x @ p["wq"].astype(dt)``).  The port casts
them once, when the model is built, which gives the same values; embed,
head and norm parameters stay float32, and the head is applied in float32
as the reference's ``_masked_logits`` does.  Training, the mesh and the
other families are not ported (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.superstep import resolve_device
from repro_torch.dist.sharding import embed_lookup, lm_head_logits
from repro_torch.models import transformer
from repro_torch.models.layers import ParamDef, apply_norm, init_leaf
from repro_torch.models.transformer import DecoderLM

# layer parameters that are matmul weights (held in cfg.dtype)
_MATMUL = ("attn", "mlp")


def _check_family(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP.md queue 1, item 9: other LM families)")


def model_schema(cfg) -> Any:
    _check_family(cfg)
    return transformer.decoder_schema(cfg)


def _build(cfg, leaf: Callable[[Tuple[str, ...], ParamDef], torch.Tensor]
           ) -> DecoderLM:
    """DecoderLM from ``leaf(path, ParamDef)`` -> float32 tensor, one leaf
    at a time (each matmul weight is cast before the next is made, so the
    float32 tree never exists whole)."""
    sch = model_schema(cfg)
    dt = getattr(torch, cfg.dtype)
    embed = leaf(("embed",), sch["embed"])
    layer_sch = transformer.layer_schema(cfg)
    layers = []
    for i in range(cfg.num_layers):
        layers.append({
            grp: {name: (leaf(("groups", "dense", grp, name, i), pd).to(dt)
                         if grp in _MATMUL
                         else leaf(("groups", "dense", grp, name, i), pd))
                  for name, pd in defs.items()}
            for grp, defs in layer_sch.items()})
    ln_f = {n: leaf(("ln_f", n), pd) for n, pd in sch["ln_f"].items()}
    head = None if cfg.tie_embeddings else leaf(("head",), sch["head"])
    return DecoderLM(cfg, embed, layers, ln_f, head)


def init_model_params(cfg, generator: torch.Generator = None,
                      device="cuda") -> DecoderLM:
    """Random weights by the reference's init laws, drawn from
    ``generator`` (a seeded ``torch.Generator`` on ``device``; seed 0 when
    None).  The draws differ from the reference's: for parity, build the
    model from the reference's weights with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    return _build(cfg, lambda path, pd: init_leaf(pd, generator, dev))


def params_from_numpy(tree: Dict, cfg, device="cuda") -> DecoderLM:
    """DecoderLM from the reference's parameter tree as numpy arrays:
    ``embed``, ``groups.dense.{ln1, attn.{wq, wk, wv, wo}, ln2,
    mlp.{wi, wo}}`` (stacked over the layers), ``ln_f`` and ``head``."""
    dev = resolve_device(device)
    sch = model_schema(cfg)

    def leaf(path, pd):
        node, stacked_shape = tree, sch
        layer = None
        for key in path:
            if isinstance(key, int):
                layer = key
            else:
                node, stacked_shape = node[key], stacked_shape[key]
        arr = np.asarray(node, dtype=np.float32)
        if arr.shape != stacked_shape.shape:
            raise ValueError(f"{'.'.join(p for p in path if isinstance(p, str))}"
                             f": shape {arr.shape}, schema "
                             f"{stacked_shape.shape}")
        return torch.tensor(arr if layer is None else arr[layer], device=dev)

    return _build(cfg, leaf)


def init_serve_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                     device="cuda") -> Dict:
    _check_family(cfg)
    return transformer.init_cache(cfg, batch, max_len, dtype, device)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def prefill(model: DecoderLM, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    """Fill the cache from a prompt.  batch: ``tokens`` (B, S) and a
    ``cache`` from :func:`init_serve_cache`, written in place.  Returns
    (last-token float32 logits (B, 1, Vp), cache)."""
    cfg = model.cfg
    dt = getattr(torch, cfg.dtype)
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    cache = batch["cache"]
    B, S = tokens.shape
    x = embed_lookup(model.embed, tokens).to(dt)
    pos = _positions(B, S, model.device)
    x, cache = transformer.apply_stack(model, x, positions=pos, cache=cache)
    x_last = apply_norm(model.ln_f, x[:, -1:], cfg)
    logits = lm_head_logits(x_last, model.head, valid_vocab=cfg.vocab_size)
    return logits, cache


def decode_step(model: DecoderLM, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    """One new token against the cache.  batch: ``tokens`` (B, 1), ``pos``
    (B,) absolute position of the new token (the cache length), ``cache``
    (updated in place).  Returns (float32 logits (B, 1, Vp), cache)."""
    cfg = model.cfg
    dt = getattr(torch, cfg.dtype)
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    pos = torch.as_tensor(batch["pos"], device=model.device)[:, None]
    x = embed_lookup(model.embed, tokens).to(dt)
    x, cache = transformer.apply_stack(model, x, positions=pos,
                                       cache=batch["cache"])
    x = apply_norm(model.ln_f, x, cfg)
    logits = lm_head_logits(x, model.head, valid_vocab=cfg.vocab_size)
    return logits, cache
