"""Mamba2-130M SSD [arXiv:2405.21060].

24L d_model=768 attention-free, ssm_state=128, headdim=64, expand=2,
vocab=50280.  Expert parallelism inapplicable (docs/DESIGN.md §4); runs under
data(+pod) parallelism; long_500k native via O(1) recurrent state.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_dconv=4,
    tie_embeddings=True, use_rope=False, positional="none",
    source="arXiv:2405.21060",
)
