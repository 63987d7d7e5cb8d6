"""Semirings for blocked graph linear algebra, on torch tensors.

Counterpart of ``repro.core.semiring``: traversals are iterated *semiring
SpMV* over dense adjacency tiles.

* SSSP / temporal traversal  ->  (min, +)  with identity +inf
* reachability / frontier    ->  (min, +) on 0/inf
* PageRank / centrality      ->  (+, x)    with identity 0

``idempotent`` marks semirings where applying the same relaxation twice is
harmless — those support the paper's subgraph-centric *local convergence*
inside one superstep.  Non-idempotent semirings (PageRank) take exactly
one SpMV per superstep.

Index tensors are int64 at every torch call site; stored structure stays
int32 and is widened where it is used.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Semiring:
    name: str
    zero: float  # identity of ``add`` (annihilator of ``mul``)
    one: float  # identity of ``mul``
    idempotent: bool
    reduce: str  # ``torch.scatter_reduce`` name of ``add``

    # y = add-reduce_i mul(x_i, w_i)
    def mul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def add_reduce(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        raise NotImplementedError

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def scatter_add(self, y: torch.Tensor, idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
        """``y[..., idx] <- add(y[..., idx], vals)`` along the last dim,
        with duplicate indices combined (an accumulating scatter, never an
        assignment: masked padding entries land on real slots as
        ``zero``)."""
        return y.scatter_reduce(-1, idx.long(), vals, self.reduce,
                                include_self=True)

    def segment_reduce(self, vals: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
        """add-reduce ``vals`` rows into ``num_segments`` buckets; empty
        segments hold the semiring zero."""
        out = self.full((num_segments,) + tuple(vals.shape[1:]),
                        vals.dtype, vals.device)
        idx = segment_ids.long().reshape((-1,) + (1,) * (vals.ndim - 1))
        return out.scatter_reduce_(0, idx.expand_as(vals), vals, self.reduce,
                                   include_self=True)

    def full(self, shape, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.full(shape, self.zero, dtype=dtype, device=device)


class _MinPlus(Semiring):
    def mul(self, x, w):
        return x + w

    def add_reduce(self, x, dim):
        return torch.amin(x, dim=dim)

    def add(self, a, b):
        return torch.minimum(a, b)  # propagates NaN, as jnp.minimum does


class _PlusMul(Semiring):
    def mul(self, x, w):
        return x * w

    def add_reduce(self, x, dim):
        return torch.sum(x, dim=dim)

    def add(self, a, b):
        return a + b


INF = float(np.inf)

MIN_PLUS = _MinPlus("min_plus", zero=INF, one=0.0, idempotent=True,
                    reduce="amin")
PLUS_MUL = _PlusMul("plus_mul", zero=0.0, one=1.0, idempotent=False,
                    reduce="sum")

SEMIRINGS = {s.name: s for s in (MIN_PLUS, PLUS_MUL)}
