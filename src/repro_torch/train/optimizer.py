"""AdamW with global-norm clipping, a cosine schedule and a configurable
moment dtype (counterpart of ``repro.train.optimizer``).

The reference returns new trees; here the update writes the parameters
and moments in place under ``torch.no_grad()``, leaf by leaf, so that a
1.3B-parameter model never holds a second copy of its masters or
moments.  Each leaf follows the reference's arithmetic in float32, step
by step (``b1 * m + (1 - b1) * g``, the bias corrections, decoupled
weight decay), so the values agree with the reference's to rounding.
``torch.optim.AdamW`` is not used: its schedule, bias correction and decay
rule differ.

Parameters and moments are lists of tensors in one order (the model's
``train_leaves``); the optimizer state is ``{"mu": [...], "nu": [...],
"step": int}``.  Weight decay applies where the reference's tree holds a
matrix: ``decay[i]`` says so for leaf i (a layer's norm scale is a
vector here but a stacked ``(L, d)`` matrix in the reference's tree, and
the reference decays it).  An update that raises after its first write
raises :class:`PartialUpdateError`: its state is half-updated and the step
must not be applied again.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch


class PartialUpdateError(RuntimeError):
    """``adamw_update`` failed after writing some leaves in place: the
    parameters and moments are half-updated, so the step cannot be
    retried on them."""


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"  # moments dtype ("bfloat16" for 100B+)


def lr_at(step: int, oc: OptConfig) -> float:
    """Linear warmup to ``oc.lr``, then cosine decay to ``min_lr_frac``."""
    if step < oc.warmup_steps:
        return oc.lr * (step + 1) / max(oc.warmup_steps, 1)
    prog = min(max((step - oc.warmup_steps)
                   / max(oc.total_steps - oc.warmup_steps, 1), 0.0), 1.0)
    return oc.lr * (oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5
                    * (1 + math.cos(math.pi * prog)))


def init_opt_state(params: Sequence[torch.Tensor],
                   oc: OptConfig) -> Dict[str, Any]:
    """Zero moments in ``oc.state_dtype``, one per parameter, step 0."""
    dt = getattr(torch, oc.state_dtype)
    return {
        "mu": [torch.zeros(p.shape, dtype=dt, device=p.device) for p in params],
        "nu": [torch.zeros(p.shape, dtype=dt, device=p.device) for p in params],
        "step": 0,
    }


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in float32 (a 0-d tensor
    on the tensors' device; no host read)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@torch.no_grad()
def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], state: Dict[str, Any],
                 oc: OptConfig, *, decay: Optional[Sequence[bool]] = None,
                 gnorm: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """One AdamW step, in place: ``params`` and ``state``'s moments are
    written, ``state["step"]`` advances.  ``decay[i]`` (default: the leaf
    has two dimensions or more, the reference's ``_is_matrix``) turns on
    decoupled weight decay for leaf i.  ``gnorm`` is the gradients' global
    norm when the caller has it.  Returns ``{"grad_norm", "lr"}``."""
    step = int(state["step"])
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(step, oc)
    b1, b2 = oc.b1, oc.b2
    bc1 = 1 - b1 ** (step + 1)
    bc2 = 1 - b2 ** (step + 1)
    if decay is None:
        decay = [p.ndim >= 2 for p in params]
    leaves = list(zip(params, grads, state["mu"], state["nu"], decay))
    writing = None  # the leaf being written, once the first write begins
    try:
        for i, (p, g, m, n, dec) in enumerate(leaves):
            g = g.float() * scale
            m32 = m.float() * b1 + g * (1 - b1)
            n32 = n.float() * b2 + g.square() * (1 - b2)
            delta = (m32 / bc1) / ((n32 / bc2).sqrt() + oc.eps)
            if dec:  # decoupled weight decay on matrices only
                delta += oc.weight_decay * p.float()
            writing = i
            p.copy_(p.float() - lr * delta)
            m.copy_(m32)
            n.copy_(n32)
            del g, m32, n32, delta
    except Exception as e:
        if writing is None:
            raise  # nothing written: the state is as it was
        raise PartialUpdateError(
            f"adamw_update failed at leaf {i} of {len(leaves)} after "
            f"writing leaves 0..{writing}: parameters and moments are "
            f"half-updated") from e
    state["step"] = step + 1
    return {"grad_norm": gnorm, "lr": torch.tensor(lr, dtype=torch.float32)}
