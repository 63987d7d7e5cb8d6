"""Family dispatcher: parameters, the training forward, cache, prefill and
decode (counterpart of ``repro.models.model``): the dense and MoE
families (a :class:`DecoderLM`) and the audio family (an
:class:`~repro_torch.models.encdec.EncDecLM`, whisper) serve and train.

Public surface:
  model_schema(cfg)                        -> the reference's param schema
  init_model_params(cfg, generator, device, trainable) -> the model,
                                              random weights
  params_from_numpy(tree, cfg, device, trainable) -> the model from the
                                              reference's parameter tree
  params_to_numpy(model)                   -> the reference's tree (numpy)
  train_leaves(model)                      -> the masters, by reference leaf
  opt_state_from_numpy / opt_state_to_numpy -> optimizer state <-> the
                                              reference's ``{mu, nu, step}``
  forward_train(model, batch)              -> (loss, metrics); audio:
                                              ``batch["frames"]``
  init_serve_cache(cfg, batch, max_len, dtype, device) -> KV cache (audio:
                                              ``{"self", "cross"}``)
  prefill(model, batch)                    -> (last-token logits, cache);
                                              audio: ``batch["frames"]``
  decode_step(model, batch)                -> (logits, cache)

The reference keeps float32 parameters and casts each matmul weight to
``cfg.dtype`` at every use (``x @ p["wq"].astype(dt)``).  For serving the
port casts them once, when the model is built, which gives the same
values; embed, head, norm parameters and the MoE router stay float32
(routing runs in float32), and the head is applied in float32 as the
reference's ``_masked_logits`` does.  A trainable model keeps every
parameter a float32 master and casts at every use, as the reference
does.  The mesh and the other families are not ported (ROADMAP.md
queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.superstep import resolve_device
from repro_torch.dist.sharding import (embed_lookup, lm_head_logits,
                                       lm_head_loss)
from repro_torch.models import encdec, moe, transformer
from repro_torch.models.layers import ParamDef, apply_norm, init_leaf
from repro_torch.models.transformer import DecoderLM

# layer parameter groups that hold matmul weights (held in cfg.dtype),
# all but the MoE router, which stays float32
_MATMUL = ("attn", "xattn", "mlp", "moe")
_FLOAT32 = (("moe", "router"),)
_FAMILIES = ("dense", "moe", "audio")  # serving and training


def _check_family(cfg) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP.md queue 1, item 9: other LM families)")


def model_schema(cfg) -> Any:
    _check_family(cfg)
    if cfg.family == "audio":
        return encdec.encdec_schema(cfg)
    return transformer.decoder_schema(cfg)


def _stacks(cfg) -> List[Tuple[str, List[Tuple[str, Tuple[int, ...]]],
                               bool]]:
    """The layer stacks of the reference's tree: (key, the layers in the
    order they run as (kind, stacked index) pairs, cross-attention)."""
    if cfg.family == "audio":
        return [("enc_groups", [("dense", (i,))
                                for i in range(cfg.encoder_layers)], False),
                ("dec_groups", transformer.layer_slots(cfg), True)]
    return [("groups", transformer.layer_slots(cfg), False)]


def _build(cfg, leaf: Callable[[Tuple, ParamDef], torch.Tensor],
           trainable: bool = False) -> DecoderLM:
    """The model from ``leaf(path, ParamDef)`` -> float32 tensor, one leaf
    at a time.  A path is the leaf's keys in the reference's tree, then
    its stacked indices (:func:`transformer.layer_slots`); an expert stack
    is made one expert at a time (the path ends in the expert's index,
    the ParamDef is one expert's), so that a float32 stack never exists
    whole.  For serving, each matmul weight is cast before the next is
    made; a trainable model keeps the float32 masters."""
    sch = model_schema(cfg)
    dt = torch.float32 if trainable else getattr(torch, cfg.dtype)
    embed = leaf(("embed",), sch["embed"])
    stacks = {key: [_build_layer(cfg, leaf, key, kind, idx, cross, dt,
                                 embed.device) for kind, idx in slots]
              for key, slots, cross in _stacks(cfg)}
    ln_f = {n: leaf(("ln_f", n), pd) for n, pd in sch["ln_f"].items()}
    head = None if cfg.tie_embeddings else leaf(("head",), sch["head"])
    if cfg.family == "audio":
        enc_ln_f = {n: leaf(("enc_ln_f", n), pd)
                    for n, pd in sch["enc_ln_f"].items()}
        return encdec.EncDecLM(cfg, embed, stacks["enc_groups"], enc_ln_f,
                               stacks["dec_groups"], ln_f, head, trainable)
    return DecoderLM(cfg, embed, stacks["groups"], ln_f, head,
                     trainable=trainable)


def _build_layer(cfg, leaf, key, kind, idx, cross, dt, device):
    """One layer's tensors, ``{group: {name: tensor}}`` (:func:`_build`)."""
    layer = {}
    for grp, defs in transformer.layer_schema(cfg, kind=kind,
                                              cross=cross).items():
        layer[grp] = {}
        for name, pd in defs.items():
            path = (key, kind, grp, name) + idx
            want = (dt if grp in _MATMUL and (grp, name) not in _FLOAT32
                    else torch.float32)
            if grp == "moe" and name in moe.EXPERT_STACKS:
                t = torch.empty(pd.shape, dtype=want, device=device)
                one = dataclasses.replace(pd, shape=pd.shape[1:],
                                          axes=pd.axes[1:])
                for e in range(pd.shape[0]):
                    t[e] = leaf(path + (e,), one)
            else:
                t = leaf(path, pd).to(want)
            layer[grp][name] = t
    return layer


def init_model_params(cfg, generator: torch.Generator = None,
                      device="cuda", trainable: bool = False) -> DecoderLM:
    """Random weights by the reference's init laws, drawn from
    ``generator`` (a seeded ``torch.Generator`` on ``device``; seed 0 when
    None).  The draws differ from the reference's: for parity, build the
    model from the reference's weights with :func:`params_from_numpy`.
    ``trainable`` builds float32 masters that require gradients."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    return _build(cfg, lambda path, pd: init_leaf(pd, generator, dev),
                  trainable)


def params_from_numpy(tree: Dict, cfg, device="cuda",
                      trainable: bool = False) -> DecoderLM:
    """The model from the reference's parameter tree as numpy arrays:
    ``embed``, ``groups`` (dense family: ``groups.dense.{ln1, attn.{wq, wk,
    wv, wo}, ln2, mlp.{wi, wo}}`` stacked over the layers; MoE family:
    ``groups.moe.{ln1, attn, ln2, moe.{router, wi, wo[, shared_wi,
    shared_wo]}}`` stacked over the groups and ``groups.dense`` over
    (groups, moe_every - 1)), ``ln_f`` and ``head``; the audio family has
    ``enc_groups.dense`` (stacked over the encoder layers) and
    ``enc_ln_f`` and, in place of ``groups``, ``dec_groups.dense`` with
    ``ln_x`` and ``xattn``.  ``trainable`` builds float32 masters that
    require gradients."""
    dev = resolve_device(device)
    sch = model_schema(cfg)

    def leaf(path, pd):
        node, stacked_shape = tree, sch
        idx = []
        for key in path:
            if isinstance(key, int):
                idx.append(key)
            else:
                node, stacked_shape = node[key], stacked_shape[key]
        arr = np.asarray(node, dtype=np.float32)
        if arr.shape != stacked_shape.shape:
            raise ValueError(f"{'.'.join(p for p in path if isinstance(p, str))}"
                             f": shape {arr.shape}, schema "
                             f"{stacked_shape.shape}")
        return torch.tensor(arr[tuple(idx)], device=dev)

    return _build(cfg, leaf, trainable)


def stack_dims(cfg, name: str) -> Tuple[int, ...]:
    """The stacked (leading) dims of the leaf ``name`` (keys joined by
    ``/``) of the reference's tree: ``(layers,)`` for the dense family's
    ``groups/dense``, ``(groups,)`` for ``groups/moe`` and ``(groups,
    moe_every - 1)`` for the MoE family's ``groups/dense``; the audio
    family's ``(encoder layers,)`` for ``enc_groups`` and ``(layers,)``
    for ``dec_groups``; ``()`` for a leaf outside the layer stacks."""
    if name.startswith("enc_groups/"):
        return (cfg.encoder_layers,)
    if name.startswith("dec_groups/"):
        return (cfg.num_layers,)
    if not name.startswith("groups/"):
        return ()
    n_groups, n_dense, has_moe = transformer._group_structure(cfg)
    if has_moe and name.startswith("groups/dense/"):
        return (n_groups, n_dense)
    return (n_groups,)


def train_leaves(model: DecoderLM) -> List[Tuple[str, List[torch.Tensor]]]:
    """The parameters by leaf of the reference's tree, in the order its
    checkpoints flatten it (keys sorted): ``(name, tensors)`` with the
    name's keys joined by ``/`` and, for a leaf of a layer stack
    (``groups``; the audio family's ``enc_groups``, ``dec_groups``), one
    tensor per layer in the row-major order of its stacked dims
    (:func:`stack_dims`), else one.  The optimizer state's lists follow
    the concatenated order."""
    out = []

    def walk(node, path):
        if isinstance(node, ParamDef):
            name = "/".join(path)
            if path[0] in ("groups", "dec_groups", "enc_groups"):
                layers = (model.enc_layers if path[0] == "enc_groups"
                          else model.stacked_layers(path[1]))
                out.append((name, [getattr(layer, path[2])[path[3]]
                                   for layer in layers]))
            elif path[0] in ("ln_f", "enc_ln_f"):
                out.append((name, [getattr(model, path[0])[path[1]]]))
            else:
                out.append((name, [getattr(model, path[0])]))
            return
        for k in sorted(node):
            walk(node[k], path + (k,))

    walk(model_schema(model.cfg), ())
    return out


def flat_leaves(model: DecoderLM) -> Tuple[List[torch.Tensor], List[bool]]:
    """The masters in :func:`train_leaves` order, and for each whether the
    reference's optimizer decays it (its leaf in the reference's tree has
    two dimensions or more: every stacked layer leaf, embed and head)."""
    params, decay = [], []
    for name, ts in train_leaves(model):
        for t in ts:
            params.append(t)
            decay.append(bool(stack_dims(model.cfg, name)) or t.ndim >= 2)
    return params, decay


def _set_leaf(tree: Dict, name: str, value) -> None:
    keys = name.split("/")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def _get_leaf(tree: Dict, name: str):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def _stacked_to_numpy(model: DecoderLM, lists: List[torch.Tensor]) -> Dict:
    """Tensors in :func:`train_leaves` order -> the reference's tree of
    float32 numpy arrays, each tensor copied once, straight into its slot
    of the stacked array (numpy has no bfloat16: bf16 widens exactly)."""
    tree, i = {}, 0
    for name, ts in train_leaves(model):
        part = lists[i:i + len(ts)]
        i += len(ts)
        inner = tuple(part[0].shape)
        arr = np.empty(stack_dims(model.cfg, name) + inner, np.float32)
        flat = arr.reshape((-1,) + inner)
        for j, t in enumerate(part):
            torch.from_numpy(flat[j]).copy_(t.detach())
        _set_leaf(tree, name, arr)
    return tree


def params_to_numpy(model: DecoderLM) -> Dict:
    """The reference's parameter tree of ``model`` as numpy arrays, layer
    leaves stacked under ``groups/dense``: what its ``init_model_params``
    returns and its checkpoints store under ``params``."""
    return _stacked_to_numpy(model, flat_leaves(model)[0])


def opt_state_to_numpy(model: DecoderLM, state: Dict[str, Any]) -> Dict:
    """Optimizer state as the reference's ``{"mu", "nu", "step"}`` tree
    (moments shaped as the parameter tree, step an int32 scalar), what its
    checkpoints store under ``opt``.  bfloat16 moments are stored widened
    to float32 (numpy has no bfloat16) and narrowed exactly on restore."""
    return {"mu": _stacked_to_numpy(model, state["mu"]),
            "nu": _stacked_to_numpy(model, state["nu"]),
            "step": np.asarray(state["step"], dtype=np.int32)}


def opt_state_from_numpy(tree: Dict, model: DecoderLM, oc) -> Dict[str, Any]:
    """The port's optimizer state (moments in ``oc.state_dtype`` on the
    model's device, in :func:`train_leaves` order) from the reference's
    ``{"mu", "nu", "step"}`` tree."""
    dt = getattr(torch, oc.state_dtype)

    def moments(sub):
        out = []
        for name, ts in train_leaves(model):
            arr = np.asarray(_get_leaf(sub, name))
            inner = tuple(ts[0].shape)
            if arr.shape != stack_dims(model.cfg, name) + inner:
                raise ValueError(f"opt state {name}: shape {arr.shape} "
                                 f"does not fit the model")
            out += [torch.tensor(np.asarray(p, dtype=np.float32),
                                 device=model.device).to(dt)
                    for p in arr.reshape((-1,) + inner)]
        return out

    return {"mu": moments(tree["mu"]), "nu": moments(tree["nu"]),
            "step": int(np.asarray(tree["step"]))}


def forward_train(model: DecoderLM, batch: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training forward: mean next-token cross-entropy of
    ``batch["labels"]`` given ``batch["tokens"]`` (both (B, S) ints),
    every layer under ``cfg.remat``, plus ``cfg.moe.aux_loss_weight``
    times the MoE layers' summed load-balance loss.  The audio family also
    takes ``batch["frames"]`` (B, Se, d): cast to ``cfg.dtype``, through
    the encoder, every decoder layer's cross K/V from its output in
    ``cfg.dtype``, then the decoder over the embedded tokens plus their
    sinusoidal positions.  Returns (loss, ``{"loss", "ce", "aux"}``);
    ``aux`` is 0 for the dense and audio families."""
    cfg = model.cfg
    _check_family(cfg)
    dt = getattr(torch, cfg.dtype)
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    labels = torch.as_tensor(batch["labels"], device=model.device)
    B, S = tokens.shape
    pos = _positions(B, S, model.device)
    if cfg.family == "audio":
        frames = torch.as_tensor(batch["frames"], device=model.device)
        enc_out = encdec.encode(model, frames.to(dt))
        cross_kv = encdec.cross_kv_all_layers(model, enc_out)
        x = encdec.decoder_embed(model, tokens, pos).to(dt)
        x, _, aux = encdec.decode_stack(model, x, positions=pos,
                                        cross_kv=cross_kv)
    else:
        x = embed_lookup(model.embed, tokens).to(dt)
        x, _, aux = transformer.apply_stack(model, x, positions=pos)
    x = apply_norm(model.ln_f, x, cfg)
    loss_ce = lm_head_loss(x, model.head, labels, valid_vocab=cfg.vocab_size)
    loss = loss_ce + cfg.moe.aux_loss_weight * aux
    return loss, {"loss": loss, "ce": loss_ce, "aux": aux}


def init_serve_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                     device="cuda") -> Dict:
    """The family's serving cache on ``device`` (the card unless the
    caller asks for the CPU): the KV cache of :func:`transformer.init_cache`;
    for the audio family ``{"self": that cache, "cross": (k, v)}``
    (:func:`encdec.init_encdec_cache`)."""
    _check_family(cfg)
    if cfg.family == "audio":
        return encdec.init_encdec_cache(cfg, batch, max_len, dtype, device)
    return transformer.init_cache(cfg, batch, max_len, dtype, device)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def prefill(model: DecoderLM, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    """Fill the cache from a prompt.  batch: ``tokens`` (B, S) and a
    ``cache`` from :func:`init_serve_cache`, written in place; for the
    audio family also ``frames`` (B, Se, d), run through the encoder once,
    whose cross K/V go into ``cache["cross"]``.  Returns (last-token
    float32 logits (B, 1, Vp), cache)."""
    cfg = model.cfg
    dt = getattr(torch, cfg.dtype)
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    cache = batch["cache"]
    B, S = tokens.shape
    pos = _positions(B, S, model.device)
    if cfg.family == "audio":
        frames = torch.as_tensor(batch["frames"], device=model.device)
        enc_out = encdec.encode(model, frames.to(dt))
        encdec.cross_kv_all_layers(model, enc_out, out=cache["cross"])
        del enc_out
        x = encdec.decoder_embed(model, tokens, pos).to(dt)
        x, _, _ = encdec.decode_stack(model, x, positions=pos,
                                      cross_kv=cache["cross"],
                                      cache=cache["self"])
    else:
        x = embed_lookup(model.embed, tokens).to(dt)
        x, cache, _ = transformer.apply_stack(model, x, positions=pos,
                                              cache=cache)
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
    cache = batch["cache"]
    if cfg.family == "audio":
        x = encdec.decoder_embed(model, tokens, pos).to(dt)
        x, _, _ = encdec.decode_stack(model, x, positions=pos,
                                      cross_kv=cache["cross"],
                                      cache=cache["self"])
    else:
        x = embed_lookup(model.embed, tokens).to(dt)
        x, cache, _ = transformer.apply_stack(model, x, positions=pos,
                                              cache=cache)
    x = apply_norm(model.ln_f, x, cfg)
    logits = lm_head_logits(x, model.head, valid_vocab=cfg.vocab_size)
    return logits, cache
