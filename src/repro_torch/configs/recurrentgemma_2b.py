"""RecurrentGemma-2B hybrid [arXiv:2402.19427].

26L d_model=2560 10H (GQA kv=1, head_dim=256) d_ff=7680 vocab=256000.
RG-LRU (lru_width=2560) + local attention (window 2048), pattern rec,rec,attn.
long_500k native (bounded attention window + O(1) recurrent state).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    lru_width=2560, conv1d_width=4, sliding_window=2048,
    act="gelu", rope_theta=1e4, tie_embeddings=True,
    source="arXiv:2402.19427",
)
