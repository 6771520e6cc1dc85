"""DBRX-Instruct 132B — the paper's own model [Table 1 / databricks blog].

40L d_model=6144 48H (GQA kv=8, head_dim=128) per-expert d_ff=10752,
16 experts top-4, vocab ~100k (tiktoken), layernorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    num_experts=16, num_experts_padded=16, experts_per_token=4,
    norm="layernorm", rope_theta=5e5,
    source="DOI:10.1145/3649601.3698722 Table 1",
)
