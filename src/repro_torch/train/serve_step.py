"""Serving steps: prefill, single-token decode with greedy choice, and a
generate loop (counterpart of ``repro.train.serve_step``), for the dense,
MoE and audio families.

The reference compiles each step with ``jax.jit`` around ``(params,
batch)``; PyTorch runs eagerly, so a step here is a closure over the
model.  Greedy decoding takes ``argmax`` (the first index on ties, as
``jnp.argmax``); temperature sampling draws from an explicit
``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import decode_step, init_serve_cache, prefill
from repro_torch.models.transformer import DecoderLM


def make_prefill_step(model: DecoderLM) -> Callable:
    def fn(batch: Dict) -> Tuple[torch.Tensor, Dict]:
        return prefill(model, batch)

    return fn


def make_decode_step(model: DecoderLM) -> Callable:
    def fn(batch: Dict):
        logits, cache = decode_step(model, batch)
        next_tok = greedy(logits)
        return next_tok, logits, cache

    return fn


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits -> (B,) int32 argmax of the last position."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, temperature: float,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy at ``temperature <= 0``, else one draw per row from
    ``softmax(logits / temperature)`` of the last position."""
    if temperature <= 0.0:
        return greedy(logits)
    probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def generate(
    model: DecoderLM,
    prompt_tokens: torch.Tensor,  # (B, S)
    *,
    max_new_tokens: int = 16,
    max_len: Optional[int] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    extra_inputs: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """Greedy/temperature generation; ``extra_inputs`` go to the prefill
    (the audio family's ``frames``).  Returns (B, max_new_tokens) int32."""
    prompt_tokens = torch.as_tensor(prompt_tokens, device=model.device)
    B, S = prompt_tokens.shape
    max_len = max_len or (S + max_new_tokens + 8)
    cache = init_serve_cache(model.cfg, B, max_len, device=model.device)
    logits, cache = prefill(model, {"tokens": prompt_tokens, "cache": cache,
                                    **(extra_inputs or {})})
    toks = [sample(logits, temperature, generator)]
    for i in range(max_new_tokens - 1):
        pos = torch.full((B,), S + i, dtype=torch.int32, device=model.device)
        logits, cache = decode_step(
            model, {"tokens": toks[-1][:, None], "pos": pos, "cache": cache})
        toks.append(sample(logits, temperature, generator))
    return torch.stack(toks, dim=1)
