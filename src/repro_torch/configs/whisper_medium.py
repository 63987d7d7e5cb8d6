"""whisper-medium [audio] — arXiv:2212.04356.  Encoder-decoder transformer.

24 encoder + 24 decoder layers, d_model=1024, 16 heads (MHA, kv=16),
head dim 64, d_ff=4096, vocab=51865, GELU MLP, LayerNorm, sinusoidal
positions (no RoPE).

The conv1d audio frontend is a stub, as in the reference: the model takes
precomputed frame embeddings (batch, 1500, d_model), 30 s of audio at 50 Hz
after the two stride-2 convolutions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1_024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4_096,
    vocab_size=51_865,
    pos_embed="sinusoidal",
    mlp_activation="gelu",
    norm="layernorm",
    encoder_layers=24,
    encoder_seq_len=1_500,
    supports_long_context=False,
)
