"""Decode attention: one new token against the KV cache.  ``kernel.py``
holds the CUDA wrapper, which keeps the signature of the reference's
``ops.decode_attention`` and is called by
``repro_torch.models.attention``; ``ref.py`` the plain version."""
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda

__all__ = ["decode_attention_cuda"]
