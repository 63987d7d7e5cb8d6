"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407.

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=32_768,
    rope_theta=1_000_000.0,
    mlp_activation="swiglu",
    norm="rmsnorm",
    supports_long_context=False,  # pure full attention -> long_500k skipped
)
