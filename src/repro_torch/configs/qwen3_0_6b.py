"""Qwen3-0.6B dense [hf:Qwen/Qwen3-8B family].

28L d_model=1024 16H (GQA kv=8, head_dim=128) d_ff=3072 vocab=151936, qk_norm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936,
    qk_norm=True, tie_embeddings=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)
