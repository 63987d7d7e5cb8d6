"""Flash attention (prefill and the training forward) and its backward.
``kernel.py`` holds the CUDA wrapper, which keeps the signature of the
reference's ``ops.flash_attention`` and is called by
``repro_torch.models.attention``; ``bwd.py`` the backward's wrapper (no
TPU counterpart); ``ref.py`` the plain versions of both; ``schedule.py``
the wgmma kernel's block schedule and a plain version that follows it."""
from repro_torch.kernels.flash_attention.bwd import flash_attention_bwd_cuda
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

__all__ = ["flash_attention_bwd_cuda", "flash_attention_cuda"]
