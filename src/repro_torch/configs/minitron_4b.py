"""minitron-4b [dense] — arXiv:2407.14679 (pruned Nemotron-4).

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
Nemotron family uses squared-ReLU MLP (non-gated) and LayerNorm.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3_072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9_216,
    vocab_size=256_000,
    rope_theta=10_000.0,
    mlp_activation="relu2",
    norm="layernorm",
    tie_embeddings=False,
    supports_long_context=False,
)
