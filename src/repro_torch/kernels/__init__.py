"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version.

Each kernel ships ``kernel.py`` (the ctypes wrapper with its launch
counter and source note) and ``ref.py`` (the plain version); the graph
kernels add ``ops.py`` (the reference's kernel-or-plain switch).  The CUDA
sources live in ``csrc/`` and are built at first use by ``_build.py``.

* ``semiring_spmm``      — blocked min-plus / plus-mul SpMV.
* ``semiring_superstep`` — fused sweep + semiring combine + halt vote.
* ``walk_plan``          — the two graph kernels' work list (runs cut
  into chunks, one CTA each), built once per tile index.
* ``flash_attention``    — prefill and training attention (causal,
  sliding window, GQA; optional log-sum-exp) and its backward (``bwd``).
* ``decode_attention``   — one new token against the KV cache (split-S).
"""
