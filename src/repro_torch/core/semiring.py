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


# integer type of a float's width, and the bits of its -0 (the sign bit
# alone, the least integer of that type): -0 is the one float whose bits
# are that integer, so an integer min over the bits finds a -0
_BITS = {2: (torch.int16, -2 ** 15), 4: (torch.int32, -2 ** 31),
         8: (torch.int64, -2 ** 63)}


def _signed_zero(m: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """A min result ``m`` with its zeros made -0 where ``neg`` (the fold
    held a -0): torch's min folds keep whichever equal operand comes
    first, jnp's order -0 below +0 whatever the order."""
    return torch.where(neg & (m == 0), -0.0, m)


class _MinPlus(Semiring):
    """(min, +).  Every fold propagates NaN and orders -0 below +0, as
    jnp.minimum, jnp.min and jax.ops.segment_min do, so that a result
    does not depend on the order of the fold."""

    def mul(self, x, w):
        return x + w

    def add_reduce(self, x, dim):
        bits, neg0 = _BITS[x.element_size()]
        return _signed_zero(torch.amin(x, dim=dim),
                            torch.amin(x.view(bits), dim=dim) == neg0)

    def add(self, a, b):
        if a.is_cuda:
            # torch's CUDA minimum already orders -0 below +0 in either
            # order (and gives NaN for a NaN operand); one launch on the
            # BSP loop's hot path.  test_min_plus_folds_on_card holds it.
            return torch.minimum(a, b)
        # equal operands fold to the OR of their bits: -0 from a -0 and a
        # +0, the value itself otherwise; NaN is never equal
        a, b = torch.broadcast_tensors(a, b)
        bits, _ = _BITS[a.element_size()]
        both = (a.view(bits) | b.view(bits)).view(a.dtype)
        return torch.where(a == b, both, torch.minimum(a, b))

    def scatter_add(self, y, idx, vals):
        idx = idx.long()
        bits, neg0 = _BITS[y.element_size()]
        neg = y.view(bits).scatter_reduce(
            -1, idx, vals.view(bits), "amin", include_self=True) == neg0
        return _signed_zero(super().scatter_add(y, idx, vals), neg)

    def segment_reduce(self, vals, segment_ids, num_segments):
        out = super().segment_reduce(vals, segment_ids, num_segments)
        bits, neg0 = _BITS[vals.element_size()]
        idx = segment_ids.long().reshape((-1,) + (1,) * (vals.ndim - 1))
        neg = torch.zeros(out.shape, dtype=bits, device=out.device)
        neg.scatter_reduce_(0, idx.expand_as(vals), vals.view(bits), "amin",
                            include_self=True)
        return _signed_zero(out, neg == neg0)


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
