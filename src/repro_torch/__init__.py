"""GoFFish temporal graph analytics, and its dense LM serving stack, on
PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX/Pallas package ``repro`` that mirrors its module names:
``repro_torch.core.engine`` is the counterpart of ``repro.core.engine``,
``repro_torch.kernels.semiring_spmm`` of ``repro.kernels.semiring_spmm``,
and so on.  It imports ``torch`` and numpy only.

What is here so far:

* the numpy base — graph model, generator, partitioner and subgraph
  discovery, subgraph topologies, blocked layout
  (``configs``, ``core.{graph,generator,partition,subgraph,blocked}``);
* GoFS, the slice store, in the JAX package's on-disk format (``gofs``),
  and the host iBSP engine with the analytics' host Computes
  (``core.ibsp``, ``core.algorithms``);
* the semirings, the stacked comm backends and the BSP superstep
  drivers (``core.{semiring,comm,superstep}``);
* the stacked ``TemporalEngine`` (``core.engine``);
* the dense LM serving path: configs, ``models`` (``DecoderLM``,
  prefill and decode over a KV cache), ``dist.sharding`` (embed and head
  on one device), ``train.serve_step`` and ``launch.serve``
  (``BatchedServer``);
* four hand-written CUDA kernels for ``sm_90a`` — the blocked semiring
  SpMV, the fused superstep stage, flash attention (prefill) and decode
  attention (``kernels/``), each beside its plain PyTorch version.

Entry points (``TemporalEngine``, ``device_graph``,
``init_model_params``, ``params_from_numpy``, ``init_serve_cache``) run
on the card by default and raise when CUDA is absent unless the caller passes
``device="cpu"``, where every kernel wrapper runs its plain version.
"""
