"""Train-step factory (counterpart of ``repro.train.train_step``): the loss's
gradient by ``loss.backward()``, optional gradient accumulation
(micro-batches), optional gradient compression with error feedback, and a
NaN-guarded AdamW update: a step whose gradient norm is not finite is
skipped, so a poisoned batch never corrupts the weights.

``train_step(model, opt_state, batch[, comp_state])`` updates the model's
float32 masters and ``opt_state`` in place and returns ``(model,
opt_state, metrics)`` (plus ``comp_state`` with a compressor), the
reference's return order.  Every gradient is computed before the first
write, so a step that raises before its update leaves no half-updated
state (the train loop retries it); an update that raises after its first
in-place write raises ``PartialUpdateError``, which the loop does not
retry.  A skipped step writes nothing: parameters and moments stay
bitwise as they were, and ``skipped`` is 1.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.models.model import (flat_leaves, forward_train, stack_dims,
                                      train_leaves)
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                        global_norm, lr_at)

METRICS = ("loss", "ce", "aux")


def _split_batch(batch: Dict[str, Any], k: int) -> List[Dict[str, Any]]:
    """k micro-batches of consecutive rows (the reference's reshape to
    ``(k, B / k, ...)``)."""
    out = []
    for i in range(k):
        mb = {}
        for n, x in batch.items():
            x = torch.as_tensor(x)
            if x.shape[0] % k:
                raise ValueError(f"batch of {x.shape[0]} rows does not "
                                 f"split into {k} micro-batches")
            m = x.shape[0] // k
            mb[n] = x[i * m:(i + 1) * m]
        out.append(mb)
    return out


def _stack_groups(model, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per-layer tensors in ``flat_leaves`` order -> one tensor per leaf of
    the reference's tree (layer leaves stacked), the leaves its compressor
    works on."""
    out, i = [], 0
    for name, ts in train_leaves(model):
        part = tensors[i:i + len(ts)]
        i += len(ts)
        lead = stack_dims(model.cfg, name)
        out.append(torch.stack(part).reshape(lead + part[0].shape) if lead
                   else part[0])
    return out


def _unstack_groups(model, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    out = []
    for (name, ts), leaf in zip(train_leaves(model), leaves):
        out += (list(leaf.reshape((-1,) + ts[0].shape).unbind(0))
                if stack_dims(model.cfg, name) else [leaf])
    return out


def make_train_step(cfg, oc: OptConfig = OptConfig(), *, accum_steps: int = 1,
                    compressor=None, cast_params_once: bool = False):
    """Returns ``train_step(model, opt_state, batch[, comp_state])``.

    ``model`` is a trainable ``DecoderLM`` (float32 masters,
    ``models.init_model_params(..., trainable=True)``) and ``opt_state``
    the optimizer's ``{"mu", "nu", "step"}`` over :func:`flat_leaves`
    order.  ``cast_params_once`` is not ported: the reference's only
    caller is its dry-run, and it comes with ``jit_train_step`` (ROADMAP
    item 11); the masters are cast at every use.  A compressor
    (``repro_torch.dist.compression``) works on the reference's leaves
    (layer leaves stacked), its state shaped so (:func:`init_comp_state`).
    """
    if cast_params_once:
        raise NotImplementedError(
            "cast_params_once comes with jit_train_step and the dry-run "
            "(ROADMAP item 11)")

    def grads_of(model, params, batch):
        for p in params:
            p.grad = None
        mbs = [batch] if accum_steps == 1 else _split_batch(batch,
                                                            accum_steps)
        metrics = None
        for mb in mbs:
            loss, m = forward_train(model, mb)
            loss.backward()
            m = {k: m[k].detach().float() for k in METRICS}
            metrics = m if metrics is None else {
                k: metrics[k] + m[k] for k in METRICS}
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        for p in params:
            p.grad = None
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            grads = [g * inv for g in grads]
            metrics = {k: v * inv for k, v in metrics.items()}
        return grads, metrics

    def train_step(model, opt_state, batch, comp_state=None):
        params, decay = flat_leaves(model)
        grads, metrics = grads_of(model, params, batch)
        extra = {}
        if compressor is not None:
            leaves, comp_state, cm = compressor.apply(
                _stack_groups(model, grads), comp_state)
            grads = _unstack_groups(model, leaves)
            extra.update(cm)
        gnorm = global_norm(grads)
        good = bool(torch.isfinite(gnorm))
        if good:
            om = adamw_update(params, grads, opt_state, oc, decay=decay,
                              gnorm=gnorm)
        else:  # the NaN guard: write nothing
            om = {"grad_norm": gnorm, "lr": torch.tensor(
                lr_at(int(opt_state["step"]), oc), dtype=torch.float32)}
        metrics = {**metrics, **om, **extra,
                   "skipped": torch.tensor(0.0 if good else 1.0)}
        out = (model, opt_state, metrics)
        return out + ((comp_state,) if compressor is not None else ())

    return train_step


def init_comp_state(model) -> List[torch.Tensor]:
    """A compressor's zero error-feedback state for ``model``: one float32
    residual per leaf of the reference's tree (layer leaves stacked), as
    the reference's ``compressor.init_state(params)`` makes it."""
    return [torch.zeros(stack_dims(model.cfg, name) + tuple(ts[0].shape),
                        dtype=torch.float32, device=ts[0].device)
            for name, ts in train_leaves(model)]
