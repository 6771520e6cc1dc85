"""MusicGen-Large decoder backbone over EnCodec tokens [arXiv:2306.05284].

48L d_model=2048 32H (kv=32: MHA) d_ff=8192 vocab=2048, GeGLU, LayerNorm,
sinusoidal positions and no RoPE.  The EnCodec frontend is a stub: the
prefill and the full-sequence forward take precomputed frame embeddings
(B, S, d_model); the decoder predicts codec tokens, and its decode step
embeds them.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048,
    act="gelu", norm="layernorm", positional="sinusoidal", use_rope=False,
    source="arXiv:2306.05284",
)
