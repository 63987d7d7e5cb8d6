"""LM stack (counterpart of ``repro.models``, dense and MoE families):
``layers`` (norms, MLPs, RoPE), ``attention`` (GQA through the flash and
decode kernels, with a KV cache for serving and without one, with a
gradient, for training), ``moe`` (the MoE layer's local path: float32
routing, first-come dispatch, the experts' batched matmuls, combine, the
shared expert, the aux loss), ``transformer`` (the layer stack, grouped
as the reference's for the MoE family, its remat policies) and ``model``
(parameters, the training forward, cache, prefill, decode)."""
from repro_torch.models.model import (
    decode_step,
    forward_train,
    init_model_params,
    init_serve_cache,
    model_schema,
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
    prefill,
)
from repro_torch.models.transformer import DecoderLM

__all__ = [
    "DecoderLM", "decode_step", "forward_train", "init_model_params",
    "init_serve_cache", "model_schema", "opt_state_from_numpy",
    "opt_state_to_numpy", "params_from_numpy", "params_to_numpy", "prefill",
]
