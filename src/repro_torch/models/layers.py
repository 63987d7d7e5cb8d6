"""Parameter schemas and common layers: norms, MLPs, RoPE, sinusoidal
positions (counterpart of ``repro.models.layers``).

A schema is a nested dict of :class:`ParamDef`, the single source of truth
for parameter shapes and init laws, as in the reference.  The reference
stores a layer stack with a leading ``layers`` axis for ``lax.scan``; the
port keeps one module per layer in an ``nn.ModuleList`` and uses
:func:`stacked` only to describe the reference's tree (its parameter
function, ``models.model.params_from_numpy``, reads that tree).

The layer functions take the parameters as a mapping (an
``nn.ParameterDict`` in the model) and compute in the reference's types:
norms in float32 cast back, matmuls in the activation type, RoPE angles in
float32.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

Schema = Any  # nested dict of ParamDef


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             f"in rank")


def init_leaf(d: ParamDef, generator: torch.Generator,
              device) -> torch.Tensor:
    """One float32 leaf drawn by the reference's init laws: ``zeros``,
    ``ones``, ``embed`` (normal times 0.02) or fan-in scaled normal.  The
    reference folds its keys with Python's ``hash`` of the path, which
    changes between processes, so the draws cannot match it bitwise; the
    laws do."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=torch.float32, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=torch.float32, device=device)
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    if d.init == "embed":
        return x.mul_(0.02 * d.scale)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    return x.mul_(d.scale / math.sqrt(max(fan_in, 1)))


def stacked(schema: Schema, n: int) -> Schema:
    """Prepend a ``layers`` axis of size n to every leaf."""
    if isinstance(schema, ParamDef):
        return dataclasses.replace(
            schema, shape=(n,) + schema.shape, axes=("layers",) + schema.axes)
    return {k: stacked(v, n) for k, v in schema.items()}


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def norm_schema(cfg) -> Dict[str, ParamDef]:
    d = cfg.d_model
    sch = {"scale": ParamDef((d,), ("embed",), "ones")}
    if cfg.norm == "layernorm":
        sch["bias"] = ParamDef((d,), ("embed",), "zeros")
    return sch


def apply_norm(p: Mapping[str, torch.Tensor], x: torch.Tensor,
               cfg) -> torch.Tensor:
    """LayerNorm or RMSNorm in float32, cast back to ``x``'s type."""
    dt = x.dtype
    x = x.float()
    if cfg.norm == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = x.square().mean(-1, keepdim=True)
        y = x * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].float()
    return y.to(dt)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def _gated(act_name: str) -> bool:
    return act_name in ("swiglu", "geglu")


def _act(act_name: str, x: torch.Tensor) -> torch.Tensor:
    if act_name in ("swiglu", "silu"):
        return F.silu(x)
    if act_name in ("geglu", "gelu"):
        # jax.nn.gelu defaults to the tanh approximation; torch's does not
        return F.gelu(x, approximate="tanh")
    if act_name == "relu":
        return F.relu(x)
    if act_name == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(act_name)


def mlp_schema(cfg, d_ff: Optional[int] = None) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    wi_cols = 2 * f if _gated(cfg.mlp_activation) else f
    return {
        "wi": ParamDef((d, wi_cols), ("embed", "ffn")),
        "wo": ParamDef((f, d), ("ffn", "embed"), scale=1.0),
    }


def apply_mlp(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg) -> torch.Tensor:
    h = x @ p["wi"].to(x.dtype)
    if _gated(cfg.mlp_activation):
        gate, up = h.chunk(2, dim=-1)
        h = _act(cfg.mlp_activation, gate) * up
    else:
        h = _act(cfg.mlp_activation, h)
    return h @ p["wo"].to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embedding (with partial-dim rotation, GLM-style)
# --------------------------------------------------------------------------

def rope_frequencies(cfg, device=None) -> torch.Tensor:
    """(rot/2,) float32 inverse frequencies; ``rot`` is the rotated part of
    the head dim, ``int(head_dim * rope_fraction)`` rounded down to even."""
    rot = int(cfg.head_dim * cfg.rope_fraction)
    rot -= rot % 2
    ar = torch.arange(0, rot, 2, dtype=torch.float32, device=device)
    return 1.0 / (cfg.rope_theta ** (ar / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: (..., S).  The rotated
    halves are computed in float32 (``x`` times float32 ``cos``/``sin``
    promotes, as in the reference) and cast back to ``x``'s type."""
    if cfg.pos_embed != "rope":
        return x
    freqs = rope_frequencies(cfg, x.device)
    rot = 2 * freqs.shape[0]
    angles = positions[..., :, None].float() * freqs  # (..., S, rot/2)
    sin = torch.sin(angles)[..., :, None, :]  # (..., S, 1, rot/2)
    cos = torch.cos(angles)[..., :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    y1 = (x1 * cos - x2 * sin).to(x.dtype)
    y2 = (x2 * cos + x1 * sin).to(x.dtype)
    return torch.cat([y1, y2, xp], dim=-1)


# --------------------------------------------------------------------------
# Sinusoidal positions (whisper)
# --------------------------------------------------------------------------

def sinusoidal_positions(max_len: int, d: int, device=None) -> torch.Tensor:
    """(max_len, d) float32 table: ``sin(pos / 10000^(2i/d))`` in the even
    columns, the cosines in the odd ones.  The cosines take
    ``angle[:, :(d + 1) // 2]`` as the reference does, which fits the odd
    columns only for an even ``d``."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10_000.0, dim / d)
    pe = torch.zeros((max_len, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle[:, : (d + 1) // 2])
    return pe
