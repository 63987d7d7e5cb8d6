"""Dense LM serving stack (counterpart of ``repro.models``, dense family):
``layers`` (norms, MLPs, RoPE), ``attention`` (GQA over a KV cache,
through the flash and decode kernels), ``transformer`` (the layer stack)
and ``model`` (parameters, cache, prefill, decode)."""
from repro_torch.models.model import (
    decode_step,
    init_model_params,
    init_serve_cache,
    model_schema,
    params_from_numpy,
    prefill,
)
from repro_torch.models.transformer import DecoderLM

__all__ = [
    "DecoderLM", "decode_step", "init_model_params", "init_serve_cache",
    "model_schema", "params_from_numpy", "prefill",
]
