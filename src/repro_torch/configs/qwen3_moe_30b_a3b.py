"""Qwen3-30B-A3B MoE [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4, head_dim=128) per-expert d_ff=768,
vocab=151936, 128 experts top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936,
    num_experts=128, num_experts_padded=128, experts_per_token=8,
    qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)
