"""glm4-9b [dense] — hf:THUDM/glm-4-9b.  RoPE (half-dim rotary), GQA.

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13_696,
    vocab_size=151_552,
    rope_theta=10_000.0,
    rope_fraction=0.5,  # GLM rotary applies to half of each head dim
    mlp_activation="swiglu",
    norm="rmsnorm",
    supports_long_context=False,
)
