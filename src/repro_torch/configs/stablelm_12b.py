"""StableLM-2-12B dense [hf:stabilityai/stablelm-2-1_6b family].

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352, LayerNorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=160,
    d_ff=13824, vocab_size=100352,
    norm="layernorm", rope_theta=1e4,
    source="hf:stabilityai/stablelm-2-1_6b",
)
