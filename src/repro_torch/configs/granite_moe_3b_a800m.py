"""Granite-3.0 3B-A800M MoE [hf:ibm-granite/granite-3.0-1b-a400m-base family].

32L d_model=1536 24H (GQA kv=8) per-expert d_ff=512 vocab=49155,
40 experts top-8.  40 % 16 != 0 -> experts padded to 48 with router-dead
entries; vocab padded 49155 -> 49408; tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    num_experts=40, num_experts_padded=48, experts_per_token=8,
    tie_embeddings=True, rope_theta=1e4,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
