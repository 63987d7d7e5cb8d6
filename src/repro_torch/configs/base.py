"""Graph collection and LM architecture configuration (counterpart of
``repro.configs.base``).

One ``ArchConfig`` covers every family of the reference (dense / moe / vlm
/ audio / hybrid / ssm), so that the port's configs compare field by field
with the reference's; the dense and MoE families have a model in the
port so far.  Family-specific knobs default to inert values.

Shapes are global: ``prefill_*`` is the prefill half of serving,
``decode_*`` / ``long_*`` the one-new-token decode step against a KV cache
of ``seq_len``, ``train_*`` a training step.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class GraphConfig:
    """Configuration of a time-series graph collection (paper §III/§VI)."""

    name: str
    num_vertices: int
    avg_degree: float
    num_instances: int
    num_partitions: int
    block_size: int = 128
    # GoFS layout knobs (paper §V-B..E)
    instances_per_slice: int = 20  # temporal packing (i1/i20)
    bins_per_partition: int = 20  # subgraph bin packing (s20/s40)
    cache_slots: int = 14  # LRU slice cache (c0/c14)
    seed: int = 0


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the LM grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


# The four LM shapes shared by every architecture.
TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # Every Nth layer is MoE (1 = all layers).
    moe_every: int = 1
    # llama4-style always-on shared expert alongside routed experts.
    shared_expert: bool = False


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class ArchConfig:
    """Complete architecture description.

    ``family`` is one of: dense | moe | vlm | audio | hybrid | ssm.
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # Attention details
    head_dim: int = 0  # 0 -> d_model // num_heads
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # glm4 rotates only half the head dim
    pos_embed: str = "rope"  # rope | sinusoidal | none
    sliding_window: int = 0  # 0 = full attention
    attn_logit_softcap: float = 0.0
    max_seq_len: int = 524_288

    # Activation / norm
    mlp_activation: str = "swiglu"  # swiglu | geglu | gelu | relu | relu2
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # Family extensions
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)

    # [audio] enc-dec: encoder depth and frame count
    encoder_layers: int = 0
    encoder_seq_len: int = 1_500

    # [vlm]: patch embeddings prepended to the text sequence
    num_image_patches: int = 0

    # [hybrid]: parallel SSM heads and learnable meta (prefix) tokens
    hybrid_ssm_heads: int = 0
    meta_tokens: int = 0

    # [ssm] xlstm: every Nth block is sLSTM; 0 = pure mLSTM
    xlstm_slstm_every: int = 0

    supports_long_context: bool = False
    has_decoder: bool = True

    # Compute and storage types
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"  # none | dots | full

    # Layer-scan unrolling of the reference's dry-run cost fit; kept so the
    # configs compare field by field, unused by the port.
    scan_unroll: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"{self.name}: num_heads {self.num_heads} not divisible by "
                f"num_kv_heads {self.num_kv_heads}")

    # ---- derived quantities -------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Embedding/head table rows, padded to a multiple of 128.  Logits
        beyond ``vocab_size`` are masked in the sampling paths."""
        return -(-self.vocab_size // 128) * 128

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.moe.num_experts > 0

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """A tiny config of the same family for CPU tests."""
        kw = dict(
            num_layers=max(2, min(4, self.num_layers)),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(2, self.num_kv_heads)),
            head_dim=32,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab_size=512,
            max_seq_len=512,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq_len=32 if self.encoder_layers else self.encoder_seq_len,
            num_image_patches=16 if self.num_image_patches else 0,
            hybrid_ssm_heads=2 if self.hybrid_ssm_heads else 0,
            meta_tokens=4 if self.meta_tokens else 0,
            sliding_window=64 if self.sliding_window else 0,
            remat="none",
        )
        if self.is_moe:
            kw["moe"] = MoEConfig(
                num_experts=4,
                top_k=min(2, self.moe.top_k),
                capacity_factor=self.moe.capacity_factor,
                moe_every=self.moe.moe_every,
            )
        if self.family in ("ssm", "hybrid"):
            kw["ssm"] = SSMConfig(state_dim=8, conv_width=4, expand=2)
        return self.with_overrides(**kw)

    def param_count(self) -> int:
        """Analytic parameter count (no biases except LayerNorm's, which it
        leaves out as the reference does)."""
        d, h = self.d_model, self.head_dim
        attn = (d * (self.num_heads * h) + 2 * d * (self.num_kv_heads * h)
                + (self.num_heads * h) * d)
        if self.mlp_activation in ("swiglu", "geglu"):
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.is_moe:
            n_moe = self.num_layers // self.moe.moe_every
            n_dense = self.num_layers - n_moe
            router = d * self.moe.num_experts
            n_ffn = self.moe.num_experts + (1 if self.moe.shared_expert else 0)
            per_layer_moe = attn + n_ffn * mlp + router + 2 * d
            per_layer_dense = attn + mlp + 2 * d
            body = n_moe * per_layer_moe + n_dense * per_layer_dense
        elif self.family == "ssm":
            body = self.num_layers * self._xlstm_block_params()
        elif self.family == "hybrid":
            ssm_inner = self.ssm.expand * d
            ssm = (
                d * ssm_inner * 2
                + ssm_inner * self.ssm.conv_width
                + ssm_inner * (self.ssm.state_dim * 2 + self._dt_rank() + 1)
                + self._dt_rank() * ssm_inner
                + ssm_inner * d
            )
            body = self.num_layers * (attn + ssm + mlp + 3 * d)
        else:
            body = self.num_layers * (attn + mlp + 2 * d)
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        enc = 0
        if self.encoder_layers:
            enc_attn = 4 * d * d
            enc = self.encoder_layers * (enc_attn + mlp + 2 * d)
            body += self.num_layers * enc_attn
        return body + emb + head + enc + d

    def _dt_rank(self) -> int:
        return self.ssm.dt_rank or -(-self.d_model // 16)

    def _xlstm_block_params(self) -> int:
        d = self.d_model
        inner = 2 * d
        m = (d * inner * 2 + 3 * inner * inner // max(1, self.num_heads)
             + 3 * inner + inner * d)
        return m + 2 * d
