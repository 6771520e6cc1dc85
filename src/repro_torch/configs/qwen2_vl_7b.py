"""Qwen2-VL-7B language backbone [arXiv:2409.12191].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, M-RoPE.
The ViT frontend is a stub: the batch carries 1024 patch embeddings,
prepended to the text tokens, with 3D M-RoPE positions for the whole
sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    mrope=True, mrope_sections=(16, 24, 24), qkv_bias=True, rope_theta=1e6,
    num_patch_tokens=1024,
    source="arXiv:2409.12191",
)
