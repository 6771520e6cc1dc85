"""Public model API of the port: ``build_model(cfg, device)`` -> ``Model``.

  init(generator)                      -> params
  init_serving(generator, mesh=None)   -> the served store (quantized as
                                          drawn); on a mesh, this rank's
                                          serve-mode blocks
  init_training(generator, mesh)       -> this rank's train-mode blocks
  init_paged_cache(num_pages, page_size, mesh=None) -> {"k", "v"} page pools
  init_cache(batch, cache_len, mesh=None) -> {"k", "v"} contiguous cache
  forward_routed(params, batch, cache, context_len, mesh=None)
                                       -> (logits, routing)
  prefill_routed(params, batch, cache, context_len, mesh=None)
                                       -> (logits, routing)  reference
  decode_step_routed(params, cache, batch, context_len, mesh=None)
                                       -> (logits, routing)
  forward(params, batch, mesh=None)    -> (logits, aux)   full sequence
  forward_seq_routed(params, batch, mesh=None) -> (logits, aux, routing)
  loss(params, batch, kernels=True, mesh=None) -> (total, {"ce", "aux"})

Every cached entry point updates its cache IN PLACE (the reference returns
a new one, which a donating caller aliases); ``prefill`` and
``decode_step`` drop the routing.  ``routing`` is None for every family
but moe.

The families: ``dense`` and ``moe`` take text tokens everywhere.
``vlm`` (Qwen2-VL's backbone) takes ``patch_embeds`` (B, P, D) prepended
to the text tokens in ``forward``, ``loss`` and ``prefill``, with
optional ``mrope_positions`` (B, S, 3) for M-RoPE (without them its
attention takes plain RoPE, as the reference's does); the loss leaves the
P patch positions out.  ``audio`` (MusicGen's decoder) takes
``frame_embeds`` (B, S, D) in ``forward``, ``loss`` and ``prefill`` and
codec token ids in ``decode_step``, with sinusoidal positions added to
the embeddings (``sinusoidal_embedding``; so does any config with
``positional="sinusoidal"``, in every entry point).  The stateful
families (``hybrid``: RecurrentGemma's RG-LRU and local attention;
``ssm``: Mamba-2) run ``forward``, ``loss``, ``prefill`` and
``decode_step``, their cache a tree of per-row states
(``transformer.stack_cache_spec``).  As in the reference,
``forward_routed`` refuses all four (the token-input attention families
alone have the unified step), and so the engine serves only the stateful
ones, through the two-program reference path.  Every family runs on a
mesh, as below: the forward and the loss over this rank's rows of every
batch input (patches, frames and M-RoPE positions with the tokens), the
cached steps in the serve layout (the vlm and audio dense blocks as the
dense family's, the hybrid's RG-LRU by channels and its local attention
by heads, the SSD block replicated).

On a mesh (``launch/mesh.py``, one rank process per mesh position) the
full-sequence forward runs the paper's expert-parallel schedules
(``core/expert_parallel.py``): ``init(gen, mesh)`` keeps this rank's
expert rows, and ``forward(params, batch, mesh)`` takes the global batch
and returns this rank's rows of it (``expert_parallel.batch_shard``).

The cached entry points (``forward_routed``, ``prefill_routed``,
``decode_step_routed``) serve on a mesh with the serve-mode layout of
``launch/sharding.py``: ``init_serving(gen, mesh)`` (or
``bridge.from_jax_params(..., mesh=, mode="serve")``) holds this rank's
block of every weight, the layers run tensor-parallel over "model"
(``transformer.ServeTP``), the MoE layer runs ``cfg.expert_parallel`` over
the whole batch on every rank, with each data block of rows planned with
its own capacity as the reference's ``shard_map`` plans it, and the
logits come back whole on every rank (the head's vocabulary columns
gathered).  The caches are built per rank (``init_paged_cache`` /
``init_cache`` with ``mesh=``).

The loss trains on a mesh with the train-mode layout: ``init_training(gen,
mesh)`` (or ``bridge.from_jax_params(..., mesh=, mode="train")``) holds
this rank's block of every weight (FSDP over "data", the experts' rows
over "model"), and ``loss(params, batch, kernels, mesh=mesh)`` takes the
global batch, computes on this rank's rows with each layer's weights
gathered for that layer (``launch/sharding.compute_view``) and the MoE
layers under ``cfg.expert_parallel``, and returns the global loss on
every rank; its gradients land in the blocks (``launch/train.py``).

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
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import collectives, expert_parallel, quant
from repro_torch.launch import sharding
from repro_torch.models import attention, layers, transformer

# the collectives counter's key for the LM head's vocabulary gather on a
# serving mesh (``perf_model.predicted_collective_bytes`` leaves it out)
HEAD = "head"


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; raises when CUDA is asked
    for (the default) but absent.  ``meta`` (shapes without storage) is
    the dry-run's (``launch/dryrun.py``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' explicitly to run its plain versions on the "
            "CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _lm_head(cfg, params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Logits in fp32: the weight is taken in x's dtype (a quantized head
    dequantized to it), as the reference does, and the product has fp32
    output (``quant.qdot_f32``), so bf16 logits are never rounded back to
    bf16 (close logits would tie and move the argmax).  ``x`` is (B, rows,
    D): the B last-valid rows of a serving step, or a whole sequence (or
    one chunk of it) in ``forward`` and ``loss``.  The head is taken (a
    quantized one dequantized, then copied to fp32) a column block at a
    time, so besides the (B, rows, V) fp32 logits the call's transient is
    one block, never a copy of the whole head."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = quant.qdot_f32(x, w, x.dtype)
    if tp is not None and tp.head:
        # this rank's vocabulary columns; every rank gets them all (booked
        # apart from the collectives the performance model predicts)
        logits = collectives.all_gather(logits, tp.mesh, "model", dim=-1,
                                        kind=HEAD)
    return logits


def _embed(cfg, params, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """Embedding rows of the tokens, clamped to the vocabulary, in the
    compute dtype.  On a serving mesh with the table split by vocabulary
    rows each rank looks up the tokens in its rows, writes zeros for the
    others, and a psum over "model" adds them up: one nonzero term per
    token, so the sum is exact."""
    w = params["embed"]
    tok = tokens.long().clamp(0, cfg.vocab_size - 1)
    if tp is None or not tp.embed:
        # F.embedding: its backward sums each token's rows in parallel
        return F.embedding(tok, w).to(cfg.torch_dtype)
    vl = cfg.vocab_padded // tp.mesh.shape["model"]
    loc = tok - tp.mesh.coords["model"] * vl
    ok = (loc >= 0) & (loc < vl)
    x = torch.where(ok[..., None], w[loc.clamp(0, vl - 1)], 0.0)
    return collectives.psum(x.to(cfg.torch_dtype), tp.mesh, "model")


def sinusoidal_embedding(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions (...) int -> (..., d) fp32: sin of each position times
    the d // 2 frequencies exp(-ln(10000) i / (d // 2)), then their cos."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _add_positions(cfg, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """x plus the sinusoidal table at ``positions``, cast to x's dtype
    first as the reference does, where the config asks for it."""
    if cfg.positional != "sinusoidal":
        return x
    return x + sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)


def _embed_inputs(cfg, params, batch, tp=None):
    """The batch's inputs -> (x (B, S, D) in the compute dtype, positions
    (B, S), M-RoPE positions (B, S, 3) or None, loss mask (B, S) fp32 or
    None: every position counts).  audio: ``frame_embeds``; vlm:
    ``patch_embeds`` (B, P, D) then the text ``tokens``, the loss mask
    leaving the P patch positions out, and ``mrope_positions`` handed on
    (vlm adds no sinusoidal table, as in the reference); the other
    families: ``tokens``."""
    dt = cfg.torch_dtype
    if cfg.family == "audio":
        x = batch["frame_embeds"].to(dt)
    elif cfg.family == "vlm":
        tok = _embed(cfg, params, batch["tokens"], tp)
        x = torch.cat([batch["patch_embeds"].to(dt), tok], dim=1)
    else:
        x = _embed(cfg, params, batch["tokens"], tp)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    if cfg.family == "vlm":
        mask = (positions >= cfg.num_patch_tokens).float()
        return x, positions, batch.get("mrope_positions"), mask
    return _add_positions(cfg, x, positions), positions, None, None


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: object
    device: torch.device

    def init(self, gen: torch.Generator | None = None, mesh=None,
             keep: dict | None = None) -> dict:
        """Random parameters drawn from ``gen`` (seed 0 on the model's
        device when omitted).  On a ``mesh`` every expert stack holds this
        rank's rows alone, equal to the same rows of the whole draw (every
        matrix is drawn; the rank keeps its own).  ``keep``: a tree of
        slices, the block of every leaf to store, or of ``quant.Sink``s,
        the weights quantized as they are drawn (``init_serving``)."""
        cfg = self.cfg
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        pdt = cfg.param_torch_dtype
        keep = keep or {}
        params = {
            "embed": layers.embed_init(gen, cfg.vocab_padded, cfg.d_model, pdt,
                                       keep.get("embed")),
            "blocks": transformer.init_blocks(cfg, gen, mesh,
                                              keep.get("blocks")),
            "final_norm": layers.norm_init(cfg.norm, cfg.d_model, pdt,
                                           self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.dense_init(
                gen, cfg.d_model, cfg.vocab_padded, pdt, (),
                keep.get("lm_head"))
        return params

    def init_serving(self, gen: torch.Generator | None = None,
                     mesh=None) -> dict:
        """The parameters ``init(gen)`` draws, stored as the engine serves
        them.  With ``weight_quant`` every matrix is rounded to the param
        dtype and quantized as it is drawn (``sharding.draw_keep``): the
        store equals ``quantize_params(init(gen))`` bit for bit, and the
        load's peak is the store plus one fp32 matrix and a column
        chunk's temporaries, never the param-dtype tree.  On a ``mesh``
        this rank keeps its serve-mode blocks (``launch/sharding.py``) of
        every matrix as it is drawn (a quantized one cut as
        ``shard_tree`` cuts the quantized whole), equal to the same
        blocks of the whole, so the one-device model of the same seed is
        its reference."""
        cfg = self.cfg
        if cfg.weight_quant != "none":
            return self.init(gen, keep=sharding.draw_keep(cfg, mesh))
        if mesh is None:
            return self.init(gen)
        return self.init(gen, keep=sharding.mode_slices(cfg, mesh, "serve"))

    def init_training(self, gen: torch.Generator | None = None,
                      mesh=None) -> dict:
        """This rank's train-mode blocks (``launch/sharding.train_specs``)
        of the parameters ``init(gen)`` draws: every matrix is drawn and
        the rank keeps its block, which equals the same block of the
        whole draw, so every mesh shape starts from the one-device
        weights of the same seed."""
        return self.init(gen, keep=sharding.mode_slices(self.cfg, mesh,
                                                        "train"))

    def _cache_layout(self, mesh) -> dict:
        """The kv heads and RG-LRU channels of this rank's caches on a
        serving mesh (all of them by default)."""
        if mesh is None:
            return {"heads": None, "channels": None}
        tp = transformer.serve_tp(self.cfg, mesh)
        return {"heads": tp.attn.hkv if tp.attn is not None else None,
                "channels": tp.rec.w if tp.rec is not None else None}

    def init_paged_cache(self, num_pages: int, page_size: int,
                         mesh=None) -> dict:
        """The page pool; on a serving mesh, of this rank's kv heads."""
        return transformer.init_paged_stack_cache(
            self.cfg, num_pages, page_size, self.cfg.torch_dtype, self.device,
            self._cache_layout(mesh)["heads"])

    def cache_specs(self, batch: int, cache_len: int) -> dict:
        return transformer.stack_cache_spec(self.cfg, batch, cache_len,
                                            self.cfg.torch_dtype)

    def init_cache(self, batch: int, cache_len: int, mesh=None,
                   seq_sharded: bool = False) -> dict:
        """The contiguous cache; on a serving mesh, of this rank's kv
        heads, or with ``seq_sharded`` (context-parallel decode, where
        ``attention.use_cp_decode`` holds) its sequence block of every kv
        head; a hybrid's recurrent states of this rank's RG-LRU channels,
        an ssm stack's states whole (its block is replicated)."""
        lay = self._cache_layout(mesh)
        if seq_sharded:
            return transformer.init_stack_cache(
                self.cfg, batch, cache_len, self.cfg.torch_dtype, self.device,
                None, mesh.shape["model"], lay["channels"])
        return transformer.init_stack_cache(
            self.cfg, batch, cache_len, self.cfg.torch_dtype, self.device,
            lay["heads"], channels=lay["channels"])

    def _serve_tp(self, mesh, context_len):
        """(the layout on a serving mesh or None, whether the contiguous
        cache is sequence-sharded)."""
        if mesh is None:
            return None, False
        tp = transformer.serve_tp(self.cfg, mesh)
        if context_len is None:
            raise ValueError("on a mesh pass context_len, the logical cache "
                             "length (a sequence-sharded cache holds a "
                             "block of it)")
        return (tp, attention.use_cp_decode(self.cfg, mesh,
                                        transformer.attn_cache_len(
                                            self.cfg, context_len)))

    def _head_last(self, params: dict, x: torch.Tensor,
                   tp=None) -> torch.Tensor:
        """Final norm and LM head of x (B, 1, D): (B, 1, V_padded) fp32."""
        x = layers.norm_apply(self.cfg.norm, params["final_norm"], x)
        return _lm_head(self.cfg, params, x, tp)

    def prefill_routed(self, params: dict, batch: dict, cache: dict,
                       context_len: int | None = None, *, mesh=None):
        """The reference engine's prefill: a whole (B, S) prompt block from
        position 0 fills the contiguous ``cache`` IN PLACE.  batch:
        {"tokens": (B, S) (vlm: (B, S - P) after "patch_embeds" (B, P, D),
        with optional "mrope_positions" (B, S, 3); audio: "frame_embeds"
        (B, S, D) instead), optional "token_mask" (B, S) bool (False
        tokens are dead-routed past the MoE), optional "rows" (B,) bool
        (the rows whose cache is written; all by default)}.  The window is
        decided at S, as in the reference.  Returns (logits (B, 1, V_padded) fp32 at
        the last position, routing (L, B*S, K) or None).  On a ``mesh``
        ``context_len`` is the logical cache length (``_serve_tp``)."""
        cfg = self.cfg
        tp, cp = self._serve_tp(mesh, context_len)
        x, positions, mrope, _ = _embed_inputs(cfg, params, batch, tp)
        window = transformer.effective_window(cfg, x.shape[1])
        x, routing = transformer.prefill_stack(
            cfg, params["blocks"], x, positions, cache, window,
            token_mask=batch.get("token_mask"), rows=batch.get("rows"),
            tp=tp, cp=cp, mrope_pos=mrope)
        return self._head_last(params, x[:, -1:], tp), routing

    def prefill(self, params: dict, batch: dict, cache: dict,
                context_len: int | None = None, *, mesh=None):
        return self.prefill_routed(params, batch, cache, context_len,
                                   mesh=mesh)[0]

    def decode_step_routed(self, params: dict, cache: dict, batch: dict,
                           context_len: int | None = None, *, mesh=None):
        """One token per row against the contiguous ``cache`` (updated IN
        PLACE).  batch: {"tokens": (B, 1) (audio: codec token ids),
        "lengths": (B,) tokens already cached, optional "token_mask" (B,
        1), optional "mrope_positions" (B, 1, 3) (vlm)}; a sinusoidal
        table is added at ``lengths``.  The window is decided at
        ``context_len`` or the cache length.  Returns (logits (B, 1,
        V_padded) fp32, routing (L, B, K) or None).  On a ``mesh`` pass
        ``context_len``: with a sequence-sharded cache the decode is
        context-parallel (``attention.attn_decode_step_cp``)."""
        cfg = self.cfg
        tp, cp = self._serve_tp(mesh, context_len)
        lengths = batch["lengths"]
        x = _add_positions(cfg, _embed(cfg, params, batch["tokens"], tp),
                           lengths[:, None].long())
        cache_len = _attn_cache_len(cfg, cache)
        window = (transformer.effective_window(cfg, context_len or cache_len)
                  if cache_len is not None else cfg.sliding_window)
        x, routing = transformer.decode_stack(
            cfg, params["blocks"], x, lengths, cache, window,
            token_mask=batch.get("token_mask"), tp=tp, cp=cp,
            mrope_pos=batch.get("mrope_positions"))
        return self._head_last(params, x, tp), routing

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
        family).  On a ``mesh`` the step runs tensor-parallel over this
        rank's serve blocks and cache, and every rank gets the whole
        logits."""
        cfg = self.cfg
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"forward_routed supports token-input attention families, "
                f"not {cfg.family!r}")
        tp = transformer.serve_tp(cfg, mesh) if mesh is not None else None
        block_tables = batch.get("block_tables")
        tokens = batch["tokens"]
        lengths = batch["lengths"]
        seg_lens = batch["seg_lens"]
        b, t = tokens.shape
        positions = lengths[:, None].long() + torch.arange(
            t, device=tokens.device)[None]
        x = _add_positions(cfg, _embed(cfg, params, tokens, tp),
                           positions)
        token_mask = batch.get("token_mask")
        if token_mask is None:
            token_mask = (torch.arange(t, device=tokens.device)[None]
                          < seg_lens[:, None])
        cache_len = (block_tables.shape[1] * cache["k"].shape[2]
                     if block_tables is not None else cache["k"].shape[2])
        window = transformer.effective_window(cfg, context_len or cache_len)
        x, routing = transformer.unified_stack(
            cfg, params["blocks"], x, positions, lengths, seg_lens, cache,
            window, token_mask, block_tables, tp)
        sel = (seg_lens.long() - 1).clamp(0, t - 1)
        x_sel = torch.gather(x, 1, sel[:, None, None].expand(b, 1, x.shape[2]))
        x_sel = layers.norm_apply(cfg.norm, params["final_norm"], x_sel)
        return _lm_head(cfg, params, x_sel, tp)[:, 0], routing

    def _trunk(self, params: dict, batch: dict, kernels: bool = True,
               mesh=None, block_specs=None):
        """Embedding, all layers and the final norm over a full sequence:
        (x (B, S, D), aux, routing (L, B*S, K) or None, the loss mask (B,
        S) or None: every position counts).  On a ``mesh``
        the rows of every batch input are this rank's batch block
        (``batch_shard``); with ``block_specs`` (a training mesh)
        ``params["blocks"]`` are this rank's train blocks under them."""
        cfg = self.cfg
        batch_axes = None
        if mesh is not None:
            batch_axes, rows = expert_parallel.batch_shard(
                mesh, _batch_size(batch))
            batch = {k: v[rows] for k, v in batch.items()}
        x, positions, mrope, mask = _embed_inputs(cfg, params, batch)
        window = transformer.effective_window(cfg, x.shape[1])
        x, aux, routing = transformer.forward_stack(
            cfg, params["blocks"], x, positions, window, kernels, mesh,
            batch_axes, block_specs, mrope)
        return layers.norm_apply(cfg.norm, params["final_norm"], x), aux, \
            routing, mask

    def forward_seq_routed(self, params: dict, batch: dict, mesh=None):
        """Full-sequence forward with no cache.  batch: {"tokens": (B, S)
        int}, or the vlm and audio inputs of ``prefill_routed``.  Returns
        (logits (B, S, V_padded) fp32, aux load-balance loss summed over
        layers, routing (L, B*S, K) int32 in token order, or None but for
        the moe family).

        On a ``mesh`` ``batch`` is the global batch (the same on every
        rank); the logits and routing are this rank's rows of it,
        ``expert_parallel.batch_shard(mesh, B)``, and aux is the global
        one.  Every MoE layer runs ``cfg.expert_parallel`` across the
        ranks, with this rank's expert rows in ``params``."""
        x, aux, routing, _ = self._trunk(params, batch, mesh=mesh)
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
        batch: {"tokens": (B, S), "labels": (B, S) int in [0, vocab)}, or
        the vlm and audio inputs of ``prefill_routed`` with "labels" (B, S)
        over the whole sequence; vlm's mean leaves the patch positions
        out, ``sum(ce * mask) / max(sum(mask), 1)`` as in the reference.
        Returns (total, {"ce", "aux"}), fp32 scalars.

        By default the forward runs the flash and grouped-FFN kernels (the
        scoring loss), which refuse inputs that require grad: no kernel has
        a backward, as the reference's Pallas kernels have none.
        ``kernels=False`` is the trainer's path (``launch/train.py``), the
        reference's ``use_kernel=False`` / ``use_flash_kernel=False``:
        ``attend`` / ``attend_chunked`` and the expert FFN in torch ops,
        which autograd differentiates; it reaches nothing in ``kernels/``.

        On a ``mesh`` (one rank process per position) ``params`` are this
        rank's train blocks (``init_training``) and ``batch`` the global
        batch; the rank computes its rows (``batch_shard``), and the loss
        is the global one on every rank: the mean CE over the global batch
        (this rank's CE sum and the row count summed over the data axes;
        vlm's masked CE sum and mask count, each summed so) plus 0.01 x
        the mesh aux (each MoE layer's mean of per-shard aux,
        as the reference's ``shard_map`` takes it).  Differentiated, every
        gradient lands in this rank's blocks (``sharding.compute_view``).
        ``kernels=True`` on a mesh is the scoring loss: the flash and
        grouped-FFN kernels run on every rank."""
        if mesh is None:
            x, aux, _, mask = self._trunk(params, batch, kernels)
            ce = self._chunked_ce(params, x, batch["labels"])
            ce = (ce.mean() if mask is None
                  else (ce * mask).sum() / mask.sum().clamp(min=1.0))
            return ce + 0.01 * aux, {"ce": ce, "aux": aux}
        specs = sharding.train_specs(self.cfg, mesh)
        axes, rows = expert_parallel.batch_shard(mesh,
                                                 batch["labels"].shape[0])
        # the leaves outside the layers, gathered once for the whole step
        top = {k: v for k, v in params.items() if k != "blocks"}
        params = dict(sharding.compute_view(
            top, {k: specs[k] for k in top}, mesh, axes),
            blocks=params["blocks"])
        x, aux, _, mask = self._trunk(params, batch, kernels, mesh,
                                      specs["blocks"])
        ce = self._chunked_ce(params, x, batch["labels"][rows])
        if mask is None:
            ce = ce.sum()
            for a in axes:
                ce = collectives.psum(ce, mesh, a)
            ce = ce / batch["labels"].numel()
        else:
            ce, count = (ce * mask).sum(), mask.sum()
            for a in axes:
                ce = collectives.psum(ce, mesh, a)
                count = collectives.psum(count, mesh, a)
            ce = ce / count.clamp(min=1.0)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _batch_size(batch: dict) -> int:
    """The rows of a full-sequence batch (its text, frames or labels)."""
    for k in ("tokens", "frame_embeds", "patch_embeds", "labels"):
        if k in batch:
            return batch[k].shape[0]
    raise ValueError(f"a batch of {sorted(batch)} has no row input")


def _attn_cache_len(cfg, cache: dict) -> int | None:
    """The attention cache's length (None for the ssm family)."""
    if cfg.family == "ssm":
        return None
    if cfg.family == "hybrid":
        return cache["attn"]["k"].shape[2]
    return cache["k"].shape[2]


POSITIONAL = ("rope", "sinusoidal", "none")


def build_model(cfg, device="cuda") -> Model:
    transformer.check_family(cfg)
    if cfg.weight_quant not in quant.LEVELS:
        raise ValueError(f"unknown weight_quant {cfg.weight_quant!r}; "
                         f"expected one of {quant.LEVELS}")
    if cfg.positional not in POSITIONAL:
        raise ValueError(f"unknown positional {cfg.positional!r}; expected "
                         f"one of {POSITIONAL}")
    return Model(cfg, resolve_device(device))
