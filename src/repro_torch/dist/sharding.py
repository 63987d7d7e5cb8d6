"""Embedding lookup, LM head and LM loss on one device (counterpart of the
helpers at the end of ``repro.dist.sharding``).

The reference threads a ``Runtime`` (mesh, logical-axis rules, activation
sharding) through the model; off-mesh every constraint is the identity.
The port runs on one device, so there is no ``Runtime``: the tensor and
sequence-parallel paths wait for multi-GPU (ROADMAP.md queue 1,
item 6: multi-GPU placement).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> embeddings (B, S, d) in the table's type."""
    return embed[tokens.long()]


def _masked_logits(x: torch.Tensor, head: torch.Tensor,
                   valid_vocab: int) -> torch.Tensor:
    """(B, S, d) x (Vp, d) -> float32 logits, padded vocab set to -1e30."""
    logits = x.float() @ head.float().t()
    Vp = head.shape[0]
    if valid_vocab < Vp:
        logits[..., valid_vocab:] = NEG_INF
    return logits


def lm_head_logits(x: torch.Tensor, head: torch.Tensor, *,
                   valid_vocab: int) -> torch.Tensor:
    """float32 logits (B, S, Vp); padded vocab rows pinned to -1e30 so that
    sampling never picks them."""
    return _masked_logits(x, head, valid_vocab)


def lm_head_loss(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                 *, valid_vocab: int) -> torch.Tensor:
    """Mean next-token cross-entropy over the positions with labels >= 0:
    ``logsumexp(logits) - logits[label]`` with float32 logits, the padded
    vocab masked and labels clipped to ``valid_vocab - 1``, as the
    reference's.  The float32 logits exist once: ``log_softmax`` (inside
    ``cross_entropy``) keeps its output for the backward, and the logits
    themselves are freed when it returns (at starcoder2-7b's 49,152-entry
    vocab, 16,384 tokens make 3.2 GB of logits)."""
    logits = _masked_logits(x, head, valid_vocab)
    lab = labels.long().clamp(0, valid_vocab - 1)
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), lab.reshape(-1),
        reduction="none").reshape(lab.shape)
    del logits
    mask = (labels >= 0).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
