"""starcoder2-7b [dense] — arXiv:2402.19173.  GQA, RoPE, 4K sliding window.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
StarCoder2 uses non-gated GELU MLP (d_ff = 4·d_model) and LayerNorm.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4_608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_432,
    vocab_size=49_152,
    rope_theta=100_000.0,
    sliding_window=4_096,
    mlp_activation="gelu",
    norm="layernorm",
    # Sliding-window attention is sub-quadratic in principle, but the
    # assignment classes starcoder2 with the full-attention archs for
    # long_500k (window 4096 ≪ 524288 makes the cell degenerate): skipped.
    supports_long_context=False,
)
