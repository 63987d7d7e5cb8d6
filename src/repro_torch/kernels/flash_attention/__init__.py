"""Flash attention (prefill).  ``kernel.py`` holds the CUDA wrapper, which
keeps the signature of the reference's ``ops.flash_attention`` and is
called by ``repro_torch.models.attention``; ``ref.py`` the plain
version; ``schedule.py`` the wgmma kernel's block schedule and a plain
version that follows it."""
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

__all__ = ["flash_attention_cuda"]
