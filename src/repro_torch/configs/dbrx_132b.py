"""dbrx-132b [moe] — hf:databricks/dbrx-base.  Fine-grained MoE 16e top-4.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6_144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10_752,
    vocab_size=100_352,
    rope_theta=500_000.0,
    mlp_activation="swiglu",
    norm="layernorm",
    moe=MoEConfig(num_experts=16, top_k=4, capacity_factor=1.25, moe_every=1),
    supports_long_context=False,
)
