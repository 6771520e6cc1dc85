"""Public model API of the port: ``build_model(cfg, device)`` -> ``Model``.

  init(generator)                      -> params
  init_paged_cache(num_pages, page_size) -> {"k", "v"} page pools
  init_cache(batch, cache_len)         -> {"k", "v"} contiguous cache
  forward_routed(params, batch, cache, context_len) -> (logits, routing)
  prefill_routed(params, batch, cache) -> (logits, routing)  reference
  decode_step_routed(params, cache, batch, context_len) -> (logits, routing)
  forward(params, batch, mesh=None)    -> (logits, aux)   full sequence
  forward_seq_routed(params, batch, mesh=None) -> (logits, aux, routing)
  loss(params, batch, kernels=True)    -> (total, {"ce", "aux"})

Every cached entry point updates its cache IN PLACE (the reference returns
a new one, which a donating caller aliases); ``prefill`` and
``decode_step`` drop the routing.  ``routing`` is None for the dense
family.

On a mesh (``launch/mesh.py``, one rank process per mesh position) the
full-sequence forward runs the paper's expert-parallel schedules
(``core/expert_parallel.py``): ``init(gen, mesh)`` keeps this rank's
expert rows, and ``forward(params, batch, mesh)`` takes the global batch
and returns this rank's rows of it (``expert_parallel.batch_shard``).  The
other entry points on a mesh are a later slice and raise.

Parameters are a plain dict in the JAX package's layout: weights
(D_in, D_out), experts (L, E, D, F) / (L, E, F, D), the dense MLP
(L, D, F) / (L, F, D), the page pool (L, P, ps, Hkv, hd) and the
contiguous cache (L, B, S, Hkv, hd), so the weight bridge
(``repro_torch.bridge``) is a copy.  Entry points run on the card unless
the caller passes ``device="cpu"``; without CUDA they raise rather than
run on the CPU.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import not_ported
from repro_torch.core import expert_parallel, quant
from repro_torch.models import layers, transformer


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; raises when CUDA is asked
    for (the default) but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' explicitly to run its plain versions on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _refuse_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise not_ported(f"{what} on a mesh", "meshes (2)")


def _lm_head(cfg, params, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32: the weight is rounded (or a quantized head
    dequantized) to x's dtype, as the reference does, then the product runs
    on fp32 copies, so bf16 logits are never rounded back to bf16 (close
    logits would tie and move the argmax).  ``x`` is (B, rows, D): the B
    last-valid rows of a serving step, or a whole sequence (or one chunk
    of it) in ``forward`` and ``loss``; besides the (B, rows, V) fp32
    logits, the fp32 copy of the weight is the call's one transient."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x.float() @ quant.materialize(w, x.dtype).to(x.dtype).float()


def _embed_inputs(cfg, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
    """Text tokens -> (x (B, S, D) in the compute dtype, positions (B, S));
    every position counts in the loss.  (Frame and patch inputs belong to
    families ``build_model`` refuses.)"""
    tokens = batch["tokens"]
    b, s = tokens.shape
    # F.embedding: its backward sums each token's rows in parallel
    x = F.embedding(tokens.long().clamp(0, cfg.vocab_size - 1),
                    params["embed"])
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    return x.to(cfg.torch_dtype), positions


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: object
    device: torch.device

    def init(self, gen: torch.Generator | None = None, mesh=None) -> dict:
        """Random parameters drawn from ``gen`` (seed 0 on the model's
        device when omitted).  On a ``mesh`` every expert stack holds this
        rank's rows alone, equal to the same rows of the whole draw (every
        matrix is drawn; the rank keeps its own)."""
        cfg = self.cfg
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        pdt = cfg.param_torch_dtype
        params = {
            "embed": layers.embed_init(gen, cfg.vocab_padded, cfg.d_model, pdt),
            "blocks": transformer.init_blocks(cfg, gen, mesh),
            "final_norm": layers.norm_init(cfg.norm, cfg.d_model, pdt,
                                           self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.dense_init(gen, cfg.d_model,
                                                  cfg.vocab_padded, pdt)
        return params

    def init_paged_cache(self, num_pages: int, page_size: int) -> dict:
        return transformer.init_paged_stack_cache(
            self.cfg, num_pages, page_size, self.cfg.torch_dtype, self.device)

    def cache_specs(self, batch: int, cache_len: int) -> dict:
        return transformer.stack_cache_spec(self.cfg, batch, cache_len,
                                            self.cfg.torch_dtype)

    def init_cache(self, batch: int, cache_len: int) -> dict:
        return transformer.init_stack_cache(
            self.cfg, batch, cache_len, self.cfg.torch_dtype, self.device)

    def _head_last(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Final norm and LM head of x (B, 1, D): (B, 1, V_padded) fp32."""
        x = layers.norm_apply(self.cfg.norm, params["final_norm"], x)
        return _lm_head(self.cfg, params, x)

    def prefill_routed(self, params: dict, batch: dict, cache: dict, *,
                       mesh=None):
        """The reference engine's prefill: a whole (B, S) prompt block from
        position 0 fills the contiguous ``cache`` IN PLACE.  batch:
        {"tokens": (B, S), optional "token_mask" (B, S) bool (False tokens
        are dead-routed past the MoE), optional "rows" (B,) bool (the rows
        whose cache is written; all by default)}.  The window is decided at
        S, as in the reference.  Returns (logits (B, 1, V_padded) fp32 at
        the last position, routing (L, B*S, K) or None)."""
        _refuse_mesh(mesh, "the reference engine's prefill")
        cfg = self.cfg
        x, positions = _embed_inputs(cfg, params, batch)
        window = transformer.effective_window(cfg, x.shape[1])
        x, routing = transformer.prefill_stack(
            cfg, params["blocks"], x, positions, cache, window,
            token_mask=batch.get("token_mask"), rows=batch.get("rows"))
        return self._head_last(params, x[:, -1:]), routing

    def prefill(self, params: dict, batch: dict, cache: dict, *, mesh=None):
        return self.prefill_routed(params, batch, cache, mesh=mesh)[0]

    def decode_step_routed(self, params: dict, cache: dict, batch: dict,
                           context_len: int | None = None, *, mesh=None):
        """One token per row against the contiguous ``cache`` (updated IN
        PLACE).  batch: {"tokens": (B, 1), "lengths": (B,) tokens already
        cached, optional "token_mask" (B, 1)}.  The window is decided at
        ``context_len`` or the cache length.  Returns (logits (B, 1,
        V_padded) fp32, routing (L, B, K) or None)."""
        _refuse_mesh(mesh, "the one-token decode")
        cfg = self.cfg
        tok = batch["tokens"].long().clamp(0, cfg.vocab_size - 1)
        x = params["embed"][tok].to(cfg.torch_dtype)
        window = transformer.effective_window(
            cfg, context_len or cache["k"].shape[2])
        x, routing = transformer.decode_stack(
            cfg, params["blocks"], x, batch["lengths"], cache, window,
            token_mask=batch.get("token_mask"))
        return self._head_last(params, x), routing

    def decode_step(self, params: dict, cache: dict, batch: dict,
                    context_len: int | None = None, *, mesh=None):
        return self.decode_step_routed(params, cache, batch, context_len,
                                       mesh=mesh)[0]

    def forward_routed(self, params: dict, batch: dict, cache: dict,
                       context_len: int | None = None, *, mesh=None):
        """Length-agnostic unified step: one (B, T) token block at per-row
        cache offsets over the paged pool or the contiguous cache.

        batch: {"tokens": (B, T) int, "lengths": (B,) int32 cache offsets,
        "seg_lens": (B,) int32 valid-token counts, optional "block_tables"
        (B, NB) int32 (the paged pool; absent: the contiguous cache),
        optional "token_mask" (B, T) bool}.  Row b appends its first
        seg_lens[b] tokens at positions lengths[b]..; ``cache`` is updated
        IN PLACE.  ``context_len`` pins the windowing decision to the
        logical context (the block tables' reach rounds up to whole pages).

        Returns (logits (B, V_padded) fp32 at each row's LAST VALID
        position, routing (L, B*T, K) int32, or None for the dense
        family)."""
        _refuse_mesh(mesh, "the unified serving step")
        cfg = self.cfg
        block_tables = batch.get("block_tables")
        tokens = batch["tokens"]
        lengths = batch["lengths"]
        seg_lens = batch["seg_lens"]
        b, t = tokens.shape
        tok = tokens.long().clamp(0, cfg.vocab_size - 1)
        x = params["embed"][tok].to(cfg.torch_dtype)
        positions = lengths[:, None].long() + torch.arange(
            t, device=tokens.device)[None]
        token_mask = batch.get("token_mask")
        if token_mask is None:
            token_mask = (torch.arange(t, device=tokens.device)[None]
                          < seg_lens[:, None])
        cache_len = (block_tables.shape[1] * cache["k"].shape[2]
                     if block_tables is not None else cache["k"].shape[2])
        window = transformer.effective_window(cfg, context_len or cache_len)
        x, routing = transformer.unified_stack(
            cfg, params["blocks"], x, positions, lengths, seg_lens, cache,
            window, token_mask, block_tables)
        sel = (seg_lens.long() - 1).clamp(0, t - 1)
        x_sel = torch.gather(x, 1, sel[:, None, None].expand(b, 1, x.shape[2]))
        x_sel = layers.norm_apply(cfg.norm, params["final_norm"], x_sel)
        return _lm_head(cfg, params, x_sel)[:, 0], routing

    def _trunk(self, params: dict, batch: dict, kernels: bool = True,
               mesh=None):
        """Embedding, all layers and the final norm over a full sequence:
        (x (B, S, D), aux, routing (L, B*S, K) or None).  On a ``mesh``
        the rows are this rank's batch block (``batch_shard``)."""
        cfg = self.cfg
        batch_axes = None
        if mesh is not None:
            batch_axes, rows = expert_parallel.batch_shard(
                mesh, batch["tokens"].shape[0])
            batch = {"tokens": batch["tokens"][rows]}
        x, positions = _embed_inputs(cfg, params, batch)
        window = transformer.effective_window(cfg, x.shape[1])
        x, aux, routing = transformer.forward_stack(
            cfg, params["blocks"], x, positions, window, kernels, mesh,
            batch_axes)
        return layers.norm_apply(cfg.norm, params["final_norm"], x), aux, \
            routing

    def forward_seq_routed(self, params: dict, batch: dict, mesh=None):
        """Full-sequence forward with no cache.  batch: {"tokens": (B, S)
        int}.  Returns (logits (B, S, V_padded) fp32, aux load-balance loss
        summed over layers, routing (L, B*S, K) int32 in token order, or
        None for the dense family).

        On a ``mesh`` ``batch`` is the global batch (the same on every
        rank); the logits and routing are this rank's rows of it,
        ``expert_parallel.batch_shard(mesh, B)``, and aux is the global
        one.  Every MoE layer runs ``cfg.expert_parallel`` across the
        ranks, with this rank's expert rows in ``params``."""
        x, aux, routing = self._trunk(params, batch, mesh=mesh)
        return _lm_head(self.cfg, params, x), aux, routing

    def forward(self, params: dict, batch: dict, mesh=None):
        """``forward_seq_routed`` without the routing: (logits, aux)."""
        return self.forward_seq_routed(params, batch, mesh)[:2]

    def _chunked_ce(self, params: dict, x: torch.Tensor, labels: torch.Tensor,
                    chunk: int = 512) -> torch.Tensor:
        """LM head + cross-entropy one sequence chunk at a time, so the
        (B, S, V) logits are never held whole: (B, S) fp32.  Each chunk runs
        under ``torch.utils.checkpoint``, as the reference's
        ``jax.checkpoint``, so a backward recomputes its logits instead of
        keeping them.  As in the reference, a sequence that is no longer
        than a chunk or not a whole number of chunks takes one pass."""
        s = x.shape[1]
        ce = lambda xx, ll: layers.softmax_cross_entropy(
            _lm_head(self.cfg, params, xx), ll, self.cfg.vocab_size)
        if s <= chunk or s % chunk != 0:
            return ce(x, labels)
        return torch.cat([checkpoint(ce, x[:, i:i + chunk],
                                     labels[:, i:i + chunk],
                                     use_reentrant=False)
                          for i in range(0, s, chunk)], dim=1)

    def loss(self, params: dict, batch: dict, kernels: bool = True, *,
             mesh=None):
        """Mean next-token cross-entropy plus 0.01 x the aux loss.
        batch: {"tokens": (B, S), "labels": (B, S) int in [0, vocab)}.
        Returns (total, {"ce", "aux"}), fp32 scalars.

        By default the forward runs the flash and grouped-FFN kernels (the
        scoring loss), which refuse inputs that require grad: no kernel has
        a backward, as the reference's Pallas kernels have none.
        ``kernels=False`` is the trainer's path (``launch/train.py``), the
        reference's ``use_kernel=False`` / ``use_flash_kernel=False``:
        ``attend`` / ``attend_chunked`` and the expert FFN in torch ops,
        which autograd differentiates; it reaches nothing in ``kernels/``."""
        _refuse_mesh(mesh, "the loss")
        x, aux, _ = self._trunk(params, batch, kernels)
        ce = self._chunked_ce(params, x, batch["labels"]).mean()
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def build_model(cfg, device="cuda") -> Model:
    if cfg.family not in ("dense", "moe"):
        raise not_ported(f"the {cfg.family!r} family", "other families")
    if cfg.weight_quant not in quant.LEVELS:
        raise ValueError(f"unknown weight_quant {cfg.weight_quant!r}; "
                         f"expected one of {quant.LEVELS}")
    if cfg.positional != "rope":
        raise not_ported(f"positional {cfg.positional!r}", "other families")
    return Model(cfg, resolve_device(device))
