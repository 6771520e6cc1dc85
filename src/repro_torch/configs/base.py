"""Config system: ``ModelConfig`` (architecture + runtime knobs), copied
from the JAX package's ``configs/base.py`` without JAX.

Every supported architecture provides a module ``configs/<id>.py``
exporting ``CONFIG`` (exact published spec); ``reduced()`` derives the CPU
smoke-test variant (<=2 layers, d_model<=512, <=4 experts).

The JAX config's ``use_kernel`` / ``use_flash_kernel`` switches are not
copied: in the port the tensor's device decides between a kernel and its
plain version (``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """Map a config dtype string to its torch dtype."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{sorted(_TORCH_DTYPES)}") from None


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int
    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 1e6
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)
    sliding_window: int | None = None     # native local attention (hybrid)
    long_context_window: int = 4096       # SWA variant for long contexts
    long_context_threshold: int = 262144  # >= this seq len -> use SWA variant
    # moe
    num_experts: int = 0
    num_experts_padded: int = 0      # >= num_experts, divisible by EP shards
    experts_per_token: int = 0
    router_norm_topk: bool = True
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_dconv: int = 4
    # hybrid (rg-lru)
    lru_width: int = 0
    conv1d_width: int = 4
    # frontend stubs
    num_patch_tokens: int = 0        # vlm: patch embeddings prepended
    # misc architecture
    act: str = "silu"
    norm: str = "rmsnorm"
    positional: str = "rope"         # rope | sinusoidal | none
    tie_embeddings: bool = False
    # runtime / paper-method knobs
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    moe_strategy: str = "dispatch"          # dense (=L_B) | dispatch (=L_R)
    expert_parallel: str = "decentralized"
    expert_replication: int = 1
    capacity_factor: float = 1.25
    ep_microchunks: int = 1
    # capacity-free decode fast path: at or below this many T*K routing
    # decisions a dispatch-strategy MoE layer takes a capacity-free form
    # (per-token gather or one-hot dense) when it is cheaper; 0 disables
    gather_decode_max_tk: int = 64
    prestack: bool = True
    remat: bool = True
    vocab_pad: int = 256
    kv_cache_shard: str = "seq"
    kv_cache_dtype: str = "native"          # native | int8 (quantized cache)
    weight_quant: str = "none"              # none | int8 | int4
    weight_quant_block: int = 128
    weight_quant_kinds: tuple = ("attn", "mlp", "experts", "lm_head")
    source: str = ""                 # citation

    # -- derived ----------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def n_params(self) -> int:
        """Total parameter count (ignores vocab/expert padding)."""
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di = self.ssm_expand * d
            h = di // self.ssm_headdim
            per = (d * (2 * di + 2 * self.ssm_state + h)
                   + self.ssm_dconv * (di + 2 * self.ssm_state)
                   + di * d + 3 * h + di)
            return emb + L * per
        attn = d * (self.num_heads + 2 * self.num_kv_heads) * self.head_dim \
            + self.num_heads * self.head_dim * d
        if self.is_moe:
            ffn = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
        else:
            ffn = 3 * d * self.d_ff
        if self.family == "hybrid":
            n_attn = sum(1 for i in range(L) if i % 3 == 2)
            n_rec = L - n_attn
            w = self.lru_width
            rec = d * w * 2 + self.conv1d_width * w + 2 * w * w + w * d + 3 * w
            return emb + n_attn * (attn + ffn) + n_rec * (rec + ffn)
        return emb + L * (attn + ffn)

    def n_active_params(self) -> int:
        """Active per-token params (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.n_params()
        d, L = self.d_model, self.num_layers
        attn = d * (self.num_heads + 2 * self.num_kv_heads) * self.head_dim \
            + self.num_heads * self.head_dim * d
        ffn = self.experts_per_token * 3 * d * self.d_ff + d * self.num_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + ffn)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts, same family."""
        d = min(self.d_model, 256)
        hd = 64
        heads = max(2, min(4, self.num_heads))
        kv = 1 if self.num_kv_heads == 1 else 2
        kw: dict[str, Any] = dict(
            name=self.name + "-reduced",
            num_layers=3 if self.family == "hybrid" else 2,
            d_model=d, vocab_size=min(self.vocab_size, 512),
            dtype="float32", param_dtype="float32", remat=False,
        )
        if self.family != "ssm":
            kw.update(num_heads=heads, num_kv_heads=kv, head_dim=hd,
                      d_ff=min(self.d_ff, 512) if self.d_ff else 0)
        if self.is_moe:
            kw.update(num_experts=4, num_experts_padded=4, experts_per_token=2)
        if self.family == "ssm":
            kw.update(ssm_state=16, ssm_headdim=32)
        if self.family == "hybrid":
            kw.update(lru_width=d, sliding_window=64)
        if self.mrope:
            kw.update(num_patch_tokens=8, head_dim=128, num_heads=2)
        return self.replace(**kw)


# ---------------------------------------------------------------------------
# input shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode | mixed
    seq_len: int         # mixed: the cache/context length
    global_batch: int
    # mixed (the unified step, ``Model.forward_routed``): the width of the
    # (B, chunk_len) token block each iteration packs at per-row offsets
    chunk_len: int = 0


def mixed_shape(name: str, cache_len: int, batch: int,
                chunk_len: int) -> ShapeSpec:
    """The unified mixed prefill/decode step's shape: a (batch,
    chunk_len) token block against a ``cache_len`` cache."""
    return ShapeSpec(name, "mixed", cache_len, batch, chunk_len=chunk_len)


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def _spec(shape: tuple, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors (shape and dtype, no storage) standing in for every
    model input of this workload, the reference's ``ShapeDtypeStruct``s.
    A ``decode`` shape covers the step's inputs only (the cache is
    ``Model.cache_specs``'); the frontend stubs appear as precomputed
    embeddings (audio frames, vision patches)."""
    b, s = shape.global_batch, shape.seq_len
    dt, i32 = cfg.torch_dtype, torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            specs = {"frame_embeds": _spec((b, s, cfg.d_model), dt),
                     "labels": _spec((b, s), i32)}
        elif cfg.family == "vlm":
            p = cfg.num_patch_tokens
            specs = {"tokens": _spec((b, s - p), i32),
                     "patch_embeds": _spec((b, p, cfg.d_model), dt),
                     "mrope_positions": _spec((b, s, 3), i32),
                     "labels": _spec((b, s), i32)}
        else:
            specs = {"tokens": _spec((b, s), i32),
                     "labels": _spec((b, s), i32)}
        if shape.kind == "prefill":
            specs.pop("labels")
        return specs
    if shape.kind == "mixed":
        c = max(shape.chunk_len, 1)
        return {"tokens": _spec((b, c), i32), "lengths": _spec((b,), i32),
                "seg_lens": _spec((b,), i32)}
    specs = {"tokens": _spec((b, 1), i32), "lengths": _spec((b,), i32)}
    if cfg.family == "vlm":
        specs["mrope_positions"] = _spec((b, 1, 3), i32)
    return specs


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

ARCH_IDS = ["qwen3_moe_30b_a3b", "granite_moe_3b_a800m", "dbrx",
            "qwen3_0_6b", "stablelm_12b", "qwen2_72b", "deepseek_67b",
            "recurrentgemma_2b", "mamba2_130m", "qwen2_vl_7b",
            "musicgen_large"]

# the reference's aliases: hyphenated ids and DBRX's model name (dotted
# names such as "qwen3-0.6b" resolve as the reference resolves them)
_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIAS.update({"dbrx": "dbrx", "dbrx-132b": "dbrx"})


def get_config(arch: str) -> ModelConfig:
    arch_mod = _ALIAS.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch_mod not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_mod}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
