"""Gradient compression with error feedback (counterpart of
``repro.dist.compression``).

The compression residual is carried in the compressor state (float32,
one tensor per gradient) and re-added before the next quantization, so
the running mean of the compressed stream is unbiased although each step
is lossy.  ``apply(grads, state) -> (compressed, new_state, metrics)``
works leaf by leaf on a list of gradients.  On one device there is no
collective: the reference's ``apply`` off the mesh is the same leaf-wise
round trip.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch


class Compressor:
    """Base: the error-feedback state is a float32 residual per gradient."""

    def init_state(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                for t in tensors]

    def _roundtrip(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor],
              state: Sequence[torch.Tensor]
              ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                         Dict[str, torch.Tensor]]:
        target = [g.float() + e for g, e in zip(grads, state)]
        out = [self._roundtrip(t) for t in target]
        new_state = [t - o for t, o in zip(target, out)]
        err_sq = sum(e.square().sum() for e in new_state)
        return out, new_state, {"comp_err_norm": torch.sqrt(err_sq)}


class Int8Compressor(Compressor):
    """Symmetric per-leaf int8 quantization (scale = max|g|/127)."""

    def _roundtrip(self, t: torch.Tensor) -> torch.Tensor:
        scale = t.abs().max() / 127.0
        safe = torch.clamp(scale, min=1e-30)
        q = torch.clamp(torch.round(t / safe), -127, 127).to(torch.int8)
        return q.float() * safe


class TopKCompressor(Compressor):
    """Keep the top ``frac`` entries of each leaf by magnitude, zero the
    rest (sparsified all-reduce); ties at the threshold are all kept."""

    def __init__(self, frac: float = 0.01):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {frac}")
        self.frac = frac

    def _roundtrip(self, t: torch.Tensor) -> torch.Tensor:
        flat = t.reshape(-1).abs()
        k = max(1, int(round(self.frac * flat.shape[0])))
        kth = torch.topk(flat, k, sorted=True).values[-1]
        return torch.where(t.abs() >= kth, t, torch.zeros_like(t))
