"""llama4-maverick-400b-a17b [moe] — hf:meta-llama/Llama-4 family.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
with an always-on shared expert (17B active of ~400B total).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5_120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8_192,
    vocab_size=202_048,
    rope_theta=500_000.0,
    mlp_activation="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        capacity_factor=1.25,
        moe_every=2,  # maverick interleaves MoE / dense layers -> ~400B total
        shared_expert=True,
    ),
    supports_long_context=False,
)
