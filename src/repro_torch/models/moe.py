"""Mixture-of-Experts layer, local path (counterpart of
``repro.models.moe``): top-k routing in float32, capacity-bounded
first-come dispatch, the experts' MLPs as batched matmuls, gate-weighted
combine, the always-on shared expert and the switch-style aux loss.

Only the reference's single-device path (``moe_apply_local``) is ported;
its expert-parallel path (``moe_apply_ep``, an all-to-all inside a
``shard_map``) waits with the tensor and sequence parallelism of ROADMAP.md
queue 1, item 6.

Three points where the port must take care to give the reference's values:

* the router is a float32 parameter and routing runs in float32, whatever
  ``cfg.dtype`` the experts compute in;
* ``jax.lax.top_k`` puts the lower expert index first on ties; the top k
  here are the first k of a stable descending sort;
* the reference adds every (token, choice) entry into the (E, C, d)
  buffer, a dropped one (past the capacity) as ``x * 0`` at slot C - 1.
  Here only the kept entries are written, which land on distinct
  (expert, slot) pairs, so the buffer is the reference's and its
  writes are deterministic; the dropped ones go to a scratch slot C that
  the experts never read.  Writing a dropped entry at slot C - 1 by
  assignment would overwrite the token kept there.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamDef, _act, _gated

Params = Any


def moe_schema(cfg) -> Dict[str, ParamDef]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    wi_cols = 2 * f if _gated(cfg.mlp_activation) else f
    sch = {
        "router": ParamDef((d, e), ("embed", "experts_r"), scale=0.1),
        "wi": ParamDef((e, d, wi_cols), ("experts", "embed", "expert_inner")),
        "wo": ParamDef((e, f, d), ("experts", "expert_inner", "embed")),
    }
    if cfg.moe.shared_expert:
        sch["shared_wi"] = ParamDef((d, wi_cols), ("embed", "ffn"))
        sch["shared_wo"] = ParamDef((f, d), ("ffn", "embed"))
    return sch


# the expert stacks: leading axis the experts, computed in cfg.dtype
EXPERT_STACKS = ("wi", "wo")


def _route(p: Params, x: torch.Tensor, cfg
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T, d) -> (top-k gates (T, k) float32 renormalised to sum 1,
    top-k experts (T, k) int32, softmax gates (T, E) float32)."""
    logits = x.float() @ p["router"].float()
    gates = torch.softmax(logits, dim=-1)
    top_g, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    top_g, top_i = top_g[:, :k], top_i[:, :k]
    top_g = top_g / top_g.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_g, top_i.to(torch.int32), gates


def _aux_stats(gates: torch.Tensor, top_i: torch.Tensor, num_experts: int):
    """(density, frac) of the switch load-balance loss: the mean gate of
    each expert and the share of tokens whose first choice it is."""
    density = gates.mean(0)
    onehot = F.one_hot(top_i[:, 0].long(), num_experts).float()
    return density, onehot.mean(0)


def _aux_loss(gates: torch.Tensor, top_i: torch.Tensor,
              num_experts: int) -> torch.Tensor:
    """Switch-transformer load-balance loss."""
    density, frac = _aux_stats(gates, top_i, num_experts)
    return num_experts * (density * frac).sum()


def _dispatch(x: torch.Tensor, top_g: torch.Tensor, top_i: torch.Tensor,
              num_experts: int, capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """First-come dispatch of x (T, d) into a buffer (E, C, d).

    An entry's slot is the number of entries before it (in flattened
    (token, choice) order) that chose the same expert; it is kept if its
    slot is below C.  Returns (buffer, slot (T, k) clamped to C - 1, keep
    (T, k) in x's type, the token of each flattened entry)."""
    T, k = top_i.shape
    E, C, d = num_experts, capacity, x.shape[-1]
    flat_e = top_i.reshape(-1).long()
    onehot = F.one_hot(flat_e, E)
    pos = onehot.cumsum(0) - onehot  # exclusive cumsum
    slot = pos.gather(1, flat_e[:, None])[:, 0]
    kept = slot < C
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    # kept entries to their own (expert, slot) rows, dropped ones to the
    # scratch slot C of their expert
    rows = flat_e * (C + 1) + torch.where(kept, slot, C)
    buf = x.new_zeros((E * (C + 1), d))
    buf = buf.index_put((rows,), x[tok])
    buf = buf.view(E, C + 1, d)[:, :C]
    return (buf, slot.clamp_max(C - 1).reshape(T, k),
            kept.to(x.dtype).reshape(T, k), tok)


def _expert_ffn(wi: torch.Tensor, wo: torch.Tensor, buf: torch.Tensor,
                cfg) -> torch.Tensor:
    """buf (E, C, d) -> (E, C, d) through each expert's MLP."""
    h = torch.bmm(buf, wi.to(buf.dtype))
    if _gated(cfg.mlp_activation):
        gate, up = h.chunk(2, dim=-1)
        h = _act(cfg.mlp_activation, gate) * up
    else:
        h = _act(cfg.mlp_activation, h)
    return torch.bmm(h, wo.to(buf.dtype))


def _combine(buf_out: torch.Tensor, top_g: torch.Tensor,
             top_i: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             T: int) -> torch.Tensor:
    """Gather the experts' outputs back to token order, each weighted by
    its gate times ``keep`` (in the activation type), summed over the k
    choices."""
    k = top_i.shape[1]
    picked = buf_out[top_i.reshape(-1).long(), slot.reshape(-1).long()]
    w = (top_g * keep.to(top_g.dtype)).reshape(-1, 1).to(picked.dtype)
    return (picked * w).reshape(T, k, -1).sum(1)


def _capacity(tokens: int, cfg) -> int:
    """Slots per expert: ``tokens * top_k * capacity_factor / E``, rounded
    up to a multiple of 8, at least 8."""
    c = int(tokens * cfg.moe.top_k * cfg.moe.capacity_factor
            / cfg.moe.num_experts)
    return max(8, -(-c // 8) * 8)


def moe_apply_local(p: Params, x: torch.Tensor, cfg, *,
                    with_aux: bool = True
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, S, d) -> ((B, S, d), aux loss).  The capacity is taken over all
    B * S tokens.  No expert parallelism.  With ``with_aux=False`` (serving,
    which discards it) the aux loss is not computed and None is returned
    in its place."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    top_g, top_i, gates = _route(p, xt, cfg)
    aux = _aux_loss(gates, top_i, cfg.moe.num_experts) if with_aux else None
    C = _capacity(B * S, cfg)
    buf, slot, keep, _ = _dispatch(xt, top_g, top_i, cfg.moe.num_experts, C)
    buf = _expert_ffn(p["wi"], p["wo"], buf, cfg)
    out = _combine(buf, top_g, top_i, slot, keep, B * S)
    if cfg.moe.shared_expert:
        h = xt @ p["shared_wi"].to(xt.dtype)
        g, u = h.chunk(2, dim=-1)
        out = out + (_act(cfg.mlp_activation, g) * u) @ p["shared_wo"].to(
            xt.dtype)
    return out.reshape(B, S, d), aux


def moe_apply(p: Params, x: torch.Tensor, cfg, runtime=None, *,
              with_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The local path; a runtime with a mesh (expert parallelism, the
    reference's ``moe_apply_ep``) is not ported."""
    if runtime is not None and getattr(runtime, "mesh", None) is not None:
        raise NotImplementedError(
            "expert parallelism (moe_apply_ep) is not ported yet (ROADMAP.md "
            "queue 1, item 6: tensor, sequence and expert parallelism)")
    return moe_apply_local(p, x, cfg, with_aux=with_aux)
