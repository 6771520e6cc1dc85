"""Serving engine of the port: continuous batching over the unified step
(the JAX package's ``serving/engine.py``).

Every iteration packs the active decode rows and pending prefill chunks
into ONE (max_batch, chunk_len) token block at per-row cache offsets
(``Model.forward_routed``); long prompts stream through the cache
``chunk_len`` tokens per iteration and admission never stalls decode.  By
default the KV cache is one page pool per layer plus per-row block tables:
admission is gated on free pages (``serving/paging.PageAllocator``) and a
radix prefix cache maps requests sharing a system prompt onto the same
pages (partial tail pages shared by copy-on-write).  ``paged=False`` keeps
the contiguous (max_batch, max_cache) cache instead, one row per slot.

``unified_step=False`` (with ``paged=False``) is the two-program reference
engine, the A/B oracle the unified step is held to: each iteration admits
queued requests with a prefill of their prompts zero-padded to
``prefill_len`` (all of them in one (max_batch, prefill_len) call, or one
call each with ``batched_prefill=False``), stalling in-flight rows, then
decodes every active row by one token.  As in the reference, a prompt
shorter than ``prefill_len`` decodes from position ``prefill_len`` and
attends its zero padding, so its tokens equal the unified step's only for
prompts of exactly ``prefill_len``.

The hot loop is asynchronous on the card: each step uploads its host
snapshots (tokens, lengths, block tables, sampling parameters, the fault
poison vector) in one pinned non-blocking copy of a freshly built buffer
the host never mutates, keeps the decode feedback token on the device, and
``_harvest`` is the only point that waits for the device (besides the
documented sync points of preemption, cancellation, deadline expiry and
the NaN guard).

Quantized serving: ``weight_quant`` int8/int4 quantizes the eligible
weights on load: as each matrix is drawn where the engine draws its own
(``Model.init_serving``), else leaf by leaf (``core/quant.quantize_params``;
already quantized leaves pass through).  ``kv_cache_dtype="int8"`` keeps
an int8 page pool with fp32 scale pools beside it.

Resilience (docs/DESIGN.md §10): ``overcommit`` admits on the context's
pages and grows decode rows a page at a time, preempting the least
entitled row into the prefix cache when the pool runs dry (restore is a
block-table remap plus at most one tail re-prefill chunk); ``priority``
orders admission and may preempt lesser rows; ``cancel`` and
``deadline_ms`` release a request's pages exactly once; a ``FaultPlan``
(``serving/faults.py``) injects allocator exhaustion, failed dispatches
and non-finite logits, which the NaN guard quarantines.  Sampling is
greedy at ``temperature == 0`` and temperature-scaled top-k Gumbel
otherwise, from a generator on the engine's device seeded by
``(sample_seed, step index)``.

On a mesh (``launch/mesh.py``) every rank process runs the same engine
on the same requests (SPMD): ``params`` are this rank's serve-mode blocks
(drawn by ``Model.init_serving`` when omitted, or from
``bridge.from_jax_params(..., mesh=, mode="serve")``), and every step
runs the model tensor-parallel over "model" with the MoE layer under
``cfg.expert_parallel``.  The rows are cut over the data axes, as the
reference's ``cache_pspec`` cuts its caches: with G the product of the
"pod" and "data" sizes, slot s belongs to data block s // (max_batch /
G), and each rank runs its block's rows from its own caches (the page
pool's ``num_pages / G`` pages, or the contiguous cache's rows, of its kv
heads or, where ``attention.use_cp_decode`` holds in the two-program
engine, of its sequence block: context-parallel decode).  Where G does
not divide ``max_batch`` every rank runs the whole batch, as the
reference does (``expert_parallel.batch_split``, the one rule).  Each data
block has a pool of ``num_pages // G`` pages (the remainder unused), a
page allocator and a prefix tree of its own, whose block
tables hold page ids of that block's pool: a prefix page is shared only
within its block, and admission, lazy growth, preemption, copy-on-write,
cancel and expiry act on the slot's block.  Every rank keeps the host
state of every block and so takes every host decision, and the same one,
or the ranks would issue different collectives and hang: each rank
samples its own rows (a stochastic row's draws are its row of the step's
(max_batch, V) draw) and the sampled tokens, the NaN guard's flags and,
with a tracker, the routing are all-gathered over the data axes each step
(booked under ``collectives.ROWS``); the one-row prefill of
``batched_prefill=False`` runs whole on every rank (1 row is not cut), the slot's block writing its
row and the others a scratch row; fault plans key on the step index, and
the one clock that could differ, the deadlines', is rank 0's, broadcast
once per step while a deadline exists (``_now``).

Ring caches and the stateful families take the reference path, as in
the reference: where the effective window at ``max_cache`` fits inside it
the contiguous cache is a ring, which takes width-1 blocks only, and the
``ssm`` and ``hybrid`` families have no unified forward, so the engine
runs the two-program path for both (``self.unified`` is False) and
refuses the paged pool.  Their cache is a tree of per-row states
(``{"conv", "ssm"}``, or ``{"rec": {"conv", "h"}, "attn": {"k",
"v"}}``), the batch axis 1 in every leaf.  On a mesh they serve through
the same path in the serve layout: the hybrid's recurrent states hold
this rank's RG-LRU channels and its attention cache its kv heads or, where
``use_cp_decode`` holds, its sequence block (context-parallel decode);
the ssm states are whole (its block is replicated).

The vlm and audio families are refused, on one device and on a mesh:
their prefill needs the batch's ``patch_embeds`` or ``frame_embeds``,
which no engine path supplies (the reference's gives them the two-program
path, whose prefill passes only the tokens, and its first step fails on
that key).  They serve through ``Model.prefill`` and ``Model.decode_step``
directly, on a mesh too.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import collectives, expert_parallel, quant
from repro_torch.core.dynamic_load import LRUExpertTracker
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.attention import use_cp_decode
from repro_torch.models.model import build_model, resolve_device
from repro_torch.models.transformer import attn_cache_len, effective_window
from repro_torch.serving import scheduler as sched
from repro_torch.serving.faults import InjectedFault
from repro_torch.serving.paging import PageAllocator, PrefixCache

# Terminal request states: a request in one of these never transitions
# again (cancel() on it is a no-op returning False) and its pages are
# already released.
TERMINAL_STATES = ("done", "cancelled", "expired", "failed")
# consecutive non-finite steps before a quarantined row is failed
NAN_RETRY_LIMIT = 3


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 32
    # per-request sampling params (greedy when temperature == 0)
    temperature: float = 0.0
    top_k: int = 0                # 0 = no top-k cut (full vocab)
    # higher admits first; ties admit FIFO.  deadline_s is an absolute
    # time.perf_counter() stamp past which the request is expired
    priority: int = 0
    deadline_s: float | None = None
    # filled by the engine
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    submit_s: float = 0.0         # wall clock at submit()
    first_token_s: float | None = None  # wall clock when token 1 harvested
    # queued -> running <-> preempted -> done | cancelled | expired | failed
    status: str = "queued"
    seq: int = 0                  # submission order; kept across preemption
    preemptions: int = 0          # times this request lost its slot
    last_preempt_epoch: int = 0   # engine epoch of the last preemption
    # virtual prompt at re-admission: the prompt plus every token generated
    # before the preemption (its pages live in the prefix tree)
    resume_tokens: np.ndarray | None = None
    nan_retries: int = 0          # consecutive quarantined steps


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine knobs, named as in the JAX package's ``EngineConfig``.  The
    port's main path is the unified paged step, so ``paged`` defaults to
    True (the reference's to False).  The reference engine
    (``unified_step=False``, and always for ring-cache archs and the ssm
    and hybrid families) needs the contiguous cache, so without
    ``paged=False`` it raises the reference's "paged KV cache requires the
    unified engine path" error."""
    max_batch: int = 8            # decode slots
    prefill_len: int = 128        # reference mode: prompts padded to this
    max_cache: int = 256          # per-request cache positions
    track_experts: bool = True
    batched_prefill: bool = True  # reference mode; False: one per request
    async_steps: bool = True      # False: harvest (sync) every step
    unified_step: bool = True
    chunk_len: int = 32           # unified block width / prefill chunk size
    # per-iteration cap on scheduled prefill tokens (0 = unlimited); decode
    # rows are exempt
    token_budget: int = 0
    sample_seed: int = 0          # seed of the stochastic sampler's draws
    paged: bool = True
    page_size: int = 16           # tokens per page
    # pool size in pages; 0 = max_batch * ceil(max_cache / page_size)
    num_pages: int = 0
    # admit on the context's pages only and grow decode rows lazily,
    # preempting under pool pressure; False reserves each request's whole
    # lifetime at admission (it can never run out of pages mid-generation)
    overcommit: bool = False


@dataclasses.dataclass(frozen=True)
class _Pending:
    """One dispatched-but-unharvested device step.  ``rows`` binds batch
    rows to their requests at dispatch time; ``tok`` is the post-step (B,)
    last-token tensor, ``routing`` the (L, routing_batch * T, K) capture
    (None for the dense family); ``obs_rows`` the rows of that capture
    that feed the tracker (the reference's batch-1 prefill captures row 0
    for its slot).  ``stalled``: a reference-mode prefill dispatched while
    decode rows were in flight (its time is their stall)."""
    kind: str                     # "prefill" | "decode" | "mixed"
    rows: tuple                   # ((slot, Request), ...)
    tok: Any
    routing: Any
    obs_rows: tuple
    routing_batch: int
    stalled: bool = False


# the batch key each frontend-stub family's prefill needs
FRONTEND_INPUTS = {"vlm": "patch_embeds", "audio": "frame_embeds"}


def reference_only(cfg, max_cache: int) -> bool:
    """Whether ``cfg`` serves through the two-program reference path only:
    the unified block step needs a token-input attention family and a
    linear cache, and the cache is clipped to the window, so any window
    <= ``max_cache`` makes it a ring, which takes width-1 blocks only."""
    if cfg.family not in ("dense", "moe"):
        return True
    win = effective_window(cfg, max_cache)
    return win is not None and win <= max_cache


def _signature(*args) -> tuple:
    """The input signature of a step body's call: each tensor's shape and
    dtype, anything else (None, a stand-in (shape, dtype)) as itself; host
    integers (a slot, a step index) are data the body indexes with, not
    part of it."""
    return tuple((tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
                 else a for a in args if not isinstance(a, int))


def _tree_map(fn, tree: dict) -> dict:
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _fold_seed(seed: int, step: int) -> int:
    """The sampler's generator seed for engine step ``step``: a function
    of (sample_seed, step) alone, so a replay draws the same stream."""
    words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return (int(words[0]) << 31 | int(words[1]) >> 1) & (2 ** 63 - 1)


class ServingEngine:
    """Continuous-batching engine over the port's Model API."""

    def __init__(self, cfg_model, engine_cfg: EngineConfig | None = None,
                 params: dict | None = None,
                 generator: torch.Generator | None = None,
                 device="cuda", mesh=None, fault_plan=None):
        ecfg = engine_cfg or EngineConfig()
        # the reference's three configuration errors, in its order
        if fault_plan is not None and not ecfg.unified_step:
            raise ValueError("fault injection requires the unified engine "
                             "path (unified_step=True)")
        if ecfg.overcommit and not ecfg.paged:
            raise ValueError("overcommit requires the paged KV cache "
                             "(EngineConfig.paged=True)")
        if ecfg.chunk_len < 1 or ecfg.token_budget < 0:
            raise ValueError(
                f"chunk_len must be >= 1 and token_budget >= 0, got "
                f"chunk_len={ecfg.chunk_len} "
                f"token_budget={ecfg.token_budget}")
        unified = ecfg.unified_step and not reference_only(cfg_model,
                                                           ecfg.max_cache)
        if ecfg.paged and not unified:
            raise ValueError(
                "paged KV cache requires the unified engine path "
                "(token-input attention family, non-ring cache, "
                "unified_step=True); pass paged=False for the reference "
                "path")
        if cfg_model.family in FRONTEND_INPUTS:
            raise ValueError(
                f"the {cfg_model.family!r} family's prefill needs the "
                f"batch's {FRONTEND_INPUTS[cfg_model.family]!r}, which the "
                f"engine has no input for (the reference's engine fails on "
                f"that key at its first step); serve it through "
                f"Model.prefill and Model.decode_step")
        if ecfg.paged and ecfg.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {ecfg.page_size}")
        self.cfg = cfg_model
        self.ecfg = ecfg
        self.mesh = mesh
        b, c = ecfg.max_batch, ecfg.max_cache
        if ecfg.paged:
            self.page_size = ecfg.page_size
            self.max_blocks = -(-c // self.page_size)
            self.num_pages = ecfg.num_pages or b * self.max_blocks
        # the data blocks G of rows, cut as the model's entry points cut
        # a batch of max_batch rows (1 where the data axes do not divide it)
        self.blocks = (mesh_lib.axes_size(
            mesh, expert_parallel.batch_split(mesh, b))
            if mesh is not None else 1)
        self.block_rows = b // self.blocks
        self.rows = (expert_parallel.batch_shard(mesh, b)[1]
                     if mesh is not None else slice(0, b))
        self.device = resolve_device(device)
        self.model = build_model(cfg_model, self.device)
        if params is None:
            # quantize-on-load as each matrix is drawn: the load holds the
            # quantized store plus one fp32 matrix, never the param-dtype
            # tree (which would not fit one card beside it at full width)
            params = self.model.init_serving(generator, mesh)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        # a caller's parameters are quantized into a new tree, leaf by
        # leaf (QuantTensor leaves, such as a drawn store's, pass through)
        self.params = quant.quantize_params(params, cfg_model)
        self.tracker = (LRUExpertTracker(cfg_model.num_layers,
                                         cfg_model.num_experts)
                        if cfg_model.is_moe and ecfg.track_experts else None)
        self.queue = sched.AdmissionQueue()
        self.slots: list[Request | None] = [None] * b
        # per-slot admission context: the tokens the occupant prefills (the
        # prompt, or on restore the longer resume_tokens)
        self.slot_ctx: list[np.ndarray | None] = [None] * b
        self._all: dict[int, Request] = {}
        self._uid = 0
        self._seq = 0
        self._iter = 0                # step() count; the fault plan's key
        self._preempt_epoch = 0       # bumps per preemption (fairness key)
        self.preempt_log: list = []   # (iter, uid, running-snapshot) tuples
        # a fault plan turns the NaN guard on: each step's per-row
        # finiteness flag is read on the host (a per-step device sync) and
        # non-finite rows are withheld from every host-state advance
        self.faults = fault_plan
        self.lengths = np.zeros((b,), np.int32)
        self.budgets = np.zeros((b,), np.int32)
        self.prefill_pos = np.zeros((b,), np.int64)
        self.temps = np.zeros((b,), np.float32)
        self.topks = np.zeros((b,), np.int32)
        self.last_tok = torch.zeros((b,), dtype=torch.int32,
                                    device=self.device)
        # the sampler's draws: reseeded per step from (sample_seed, step
        # index) on the host, drawn on the engine's device.  The sort and
        # the draws run only once a stochastic request was submitted
        self._sample_gen = torch.Generator(device=self.device)
        self._step_idx = 0
        self._sampling = False
        self._pending: list[_Pending] = []
        # Signature accounting (analysis rule R3, the reference's
        # ``trace_counts``): each step body counts the distinct input
        # signatures it has run with, shapes, dtypes and the static
        # sampling flag.  A new signature is what a retrace is under the
        # reference's ``jit`` and what a CUDA-graph capture of the body
        # would have to record again.  Host bookkeeping only.
        self.trace_counts: collections.Counter = collections.Counter()
        self._signatures: set = set()
        self.unified = unified
        self.paged = ecfg.paged
        self._admit_stalled = False
        self.chunk_len = min(ecfg.chunk_len, c)
        if self.paged:
            # a pool, an allocator and a prefix tree for each data block;
            # block tables hold page ids of their block's pool, and this
            # rank holds its block's pool
            self.block_pages = self.num_pages // self.blocks
            self.cache = self.model.init_paged_cache(
                self.block_pages, self.page_size, mesh)
            self.block_tables = np.zeros((b, self.max_blocks), np.int32)
            self.allocators = [PageAllocator(self.block_pages)
                               for _ in range(self.blocks)]
            self.prefixes = [PrefixCache(self.page_size, a)
                             for a in self.allocators]
            self.slot_pages: list[list[int]] = [[] for _ in range(b)]
        else:
            # the two-program engine decodes context-parallel on a mesh
            # where the reference would (``use_cp_decode``, at the length
            # of the cache: a ring's is the window)
            self._seq_sharded = not self.unified and use_cp_decode(
                cfg_model, self.mesh, attn_cache_len(cfg_model, c))
            self.cache = self.model.init_cache(b, c, self.mesh,
                                               self._seq_sharded)
            self._scratch = None      # ``_prefill_one``'s row elsewhere
        self.stats = {"prefill_tokens": 0, "prefill_pad_tokens": 0,
                      "decode_steps": 0, "decode_tokens": 0,
                      # per-phase token counts of MIXED iterations only —
                      # throughput() apportions mixed_s by their share
                      "mixed_prefill_tokens": 0, "mixed_decode_tokens": 0,
                      "prefill_s": 0.0, "decode_s": 0.0, "mixed_s": 0.0,
                      # reference mode: time in-flight decode rows sat
                      # behind a separate prefill call
                      "stall_s": 0.0,
                      "prefix_lookups": 0, "prefix_hits": 0,
                      "prefix_hit_tokens": 0, "cow_copies": 0,
                      "pages_hwm": 0,
                      # resilience counters
                      "preemptions": 0, "restores": 0,
                      "restore_hit_tokens": 0, "cancelled": 0,
                      "expired": 0, "failed": 0,
                      "alloc_stalls": 0, "dispatch_failures": 0,
                      "nan_quarantines": 0, "active_hwm": 0}

    # -- device step ------------------------------------------------------

    def _note(self, body: str, *args, sampling: bool = True) -> None:
        """Count ``body``'s signature for ``args`` if it is new."""
        sig = (body, self._sampling if sampling else None) + _signature(
            *args)
        if sig not in self._signatures:
            self._signatures.add(sig)
            self.trace_counts[body] += 1

    def _upload(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """Hand this step's host snapshots to the device in ONE copy.

        The int32 staging buffer is built fresh here and never mutated by
        the host afterwards, so on the card it is pinned and copied
        without blocking (the scheduler mutates ``lengths`` and the block
        tables right after dispatch; the device sees the snapshot).  fp32
        arrays (temperatures, the poison vector, which may hold NaN or
        inf) travel as their bits and come back as fp32 views."""
        flat = np.concatenate([
            (a.view(np.int32) if a.dtype == np.float32
             else np.asarray(a, np.int32)).reshape(-1)
            for a in map(np.ascontiguousarray, arrays)])
        host = torch.from_numpy(flat)
        if self.device.type == "cuda":
            dev = host.pin_memory().to(self.device, non_blocking=True)
        else:
            dev = host
        out, off = [], 0
        for a in arrays:
            t = dev[off:off + a.size].view(a.shape)
            out.append(t.view(torch.float32) if a.dtype == np.float32 else t)
            off += a.size
        return out

    def _sample_next(self, logits: torch.Tensor, temps: torch.Tensor,
                     topks: torch.Tensor, step_idx: int,
                     rows: slice | None = None) -> torch.Tensor:
        """Per-row sampling on the device: greedy argmax where temperature
        == 0, otherwise temperature-scaled top-k Gumbel over the real
        vocabulary (never a padded column).  The draws come from the
        engine's generator reseeded with (sample_seed, ``step_idx``); row
        i's draws are row i of one (B, V) draw, so they depend on the slot,
        and a replay with the same seed on the same device repeats them.
        Ties at the k-th value are all kept (``scaled >= kth``).

        Until the first stochastic submit() the sort and the draws do not
        run: a greedy-only serve is one argmax.

        logits: (B, V_padded) fp32; temps: (B,) fp32; topks: (B,) int32
        (0 = full vocab).  ``rows``: the rows of the step's (max_batch, V)
        draw these B rows are (a data block's; the draw's own B rows by
        default).  Returns (B,) int32."""
        v = self.cfg.vocab_size
        logits = logits[:, :v].float()
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        if not self._sampling:
            return greedy
        # a named range, so a profile can read the sampler's device time
        with torch.profiler.record_function("sample_next"):
            gen = self._sample_gen
            gen.manual_seed(_fold_seed(self.ecfg.sample_seed, step_idx))
            u = torch.rand(logits.shape if rows is None
                           else (self.ecfg.max_batch, v), generator=gen,
                           device=logits.device)
            if rows is not None:
                u = u[rows]
            gumbel = -torch.log(-torch.log(u.clamp_min(
                torch.finfo(torch.float32).tiny)))
            scaled = logits / temps.clamp_min(1e-6)[:, None]
            desc = torch.sort(scaled, dim=-1, descending=True).values
            kth = torch.gather(desc, 1,
                               (topks.clamp(1, v) - 1).long()[:, None])
            keep = (scaled >= kth) | (topks[:, None] <= 0)
            samp = torch.argmax(torch.where(keep, scaled + gumbel,
                                            -torch.inf),
                                dim=-1).to(torch.int32)
            return torch.where(temps > 0, samp, greedy)

    def _unified(self, tokens, lengths, seg_lens, block_tables, is_decode,
                 sample_mask, temps, topks, poison, step_idx: int):
        """ONE step for prefill chunks, decode rows, and any mix.

        Decode rows take their input token from the device-resident
        ``last_tok`` (column 0), so the decode feedback loop never syncs.
        Rows in ``sample_mask`` (decode rows and final prefill chunks)
        replace ``last_tok`` with their sampled token.  The cache (the page
        pool, or with ``block_tables`` None the contiguous cache) is
        updated in place.

        ``poison`` (B,) fp32 is the fault-injection vector, or None (the
        steady state, which injects nothing): a non-finite entry
        overwrites that row's logits.  The step always returns a per-row ``bad``
        finiteness flag and never lets a non-finite row overwrite
        ``last_tok``, whether or not the host guard reads the flag.
        Returns (last_tok', routing (L, B*T, K), bad (B,) bool)."""
        # the reference passes its all-finite poison vector every step:
        # a step with none has the signature of one with a (B,) fp32 one
        self._note("unified", tokens, lengths, seg_lens, block_tables,
                   is_decode, sample_mask, temps, topks,
                   poison if poison is not None
                   else ((tokens.shape[0],), torch.float32))
        tok0 = torch.where(is_decode, self.last_tok, tokens[:, 0])
        tokens = torch.cat([tok0[:, None], tokens[:, 1:]], dim=1)
        # context_len pins the windowing decision to the logical context:
        # the block tables' reach rounds up to whole pages
        batch = {"tokens": tokens, "lengths": lengths, "seg_lens": seg_lens}
        if block_tables is not None:
            batch["block_tables"] = block_tables
        logits, routing = self.model.forward_routed(
            self.params, batch, self.cache, context_len=self.ecfg.max_cache,
            mesh=self.mesh)
        rows = self.rows
        if poison is not None:
            poison = poison[rows]
            logits = torch.where(torch.isfinite(poison)[:, None], logits,
                                 poison[:, None])
        bad = ~torch.isfinite(logits[:, :self.cfg.vocab_size]).all(dim=-1)
        nxt = self._sample_next(logits, temps[rows], topks[rows], step_idx,
                                rows)
        tok = torch.where(sample_mask[rows] & ~bad, nxt, self.last_tok[rows])
        tok, bad, routing = self._gather_rows(tok, bad, routing)
        return tok, routing, bad

    def _gather_rows(self, tok: torch.Tensor, bad: torch.Tensor, routing):
        """Every data block's sampled tokens (B/G,), NaN-guard flags (B/G,)
        and, with a tracker, routing (L, B/G*T, K), whole on every rank:
        one all-gather a data axis of the three packed by row as int32
        (``expert_parallel.batch_unshard``, booked under
        ``collectives.ROWS``).  Off a cut mesh they are whole already."""
        if self.blocks == 1:
            return tok, bad, routing
        n = tok.shape[0]
        parts = [tok[:, None].to(torch.int32), bad[:, None].to(torch.int32)]
        track = self.tracker is not None and routing is not None
        if track:
            nl, _, k = routing.shape
            parts.append(routing.reshape(nl, n, -1).transpose(0, 1)
                         .reshape(n, -1).to(torch.int32))
        packed = expert_parallel.batch_unshard(
            self.mesh, torch.cat(parts, dim=1), self.ecfg.max_batch)
        tok, bad = packed[:, 0], packed[:, 1] != 0
        if track:
            routing = packed[:, 2:].reshape(packed.shape[0], nl, -1, k) \
                .transpose(0, 1).reshape(nl, -1, k)
        return tok, bad, routing

    def _copy_pages(self, src: list[int], dst: list[int],
                    block: int = 0) -> None:
        """Device half of copy-on-write: duplicate pool pages ``src`` into
        ``dst`` of data block ``block``'s pool across every layer and every
        pool leaf (an int8 cache's scale pools too), in place (page-sized
        traffic), on the ranks that hold that pool."""
        self._note("copy_pages", ((len(src),), torch.int32), sampling=False)
        if block != self._block(self.rows.start):
            return                    # another data block's pool
        for s, d in zip(src, dst):
            for pool in self.cache.values():
                pool[:, d].copy_(pool[:, s])

    def _prefill_batch(self, tokens, admit, temps, topks, step_idx: int):
        """Reference mode: admit up to max_batch requests in ONE call.
        tokens (B, prefill_len), zeros on rows not admitted; admit (B,)
        bool.  The whole block runs (in-flight rows dead-routed past the
        MoE, so the dispatch capacity is the whole block's, as in the
        reference), and only admitted rows write their cache.  Returns
        (last_tok', routing)."""
        self._note("prefill_batch", tokens, admit, temps, topks)
        tmask = admit[:, None].expand(tokens.shape)
        logits, routing = self.model.prefill_routed(
            self.params, {"tokens": tokens, "token_mask": tmask,
                          "rows": admit}, self.cache, self.ecfg.max_cache,
            mesh=self.mesh)
        rows = self.rows
        nxt = self._sample_next(logits[:, -1], temps[rows], topks[rows],
                                step_idx, rows)
        tok = torch.where(admit[rows], nxt, self.last_tok[rows])
        tok, _, routing = self._gather_rows(tok, admit[rows], routing)
        return tok, routing

    def _prefill_one(self, tokens, slot: int, temps, topks, step_idx: int):
        """Reference mode with ``batched_prefill=False``: a batch-1 prefill
        of (1, prefill_len) tokens through slot ``slot``'s row of the
        cache (a view, written in place).  On a cut mesh the one row runs
        whole on every rank (the data axes do not divide it, as in the
        reference): the slot's data block writes its row, every other
        rank a scratch row it never reads.  Returns (last_tok',
        routing)."""
        self._note("prefill_one", tokens, slot, temps, topks)
        if self._mine(slot):
            r = slot - self.rows.start
            one = _tree_map(lambda v: v[:, r:r + 1], self.cache)
        else:
            if self._scratch is None:
                self._scratch = self.model.init_cache(
                    1, self.ecfg.max_cache, self.mesh,
                    self._seq_sharded)
            one = self._scratch
        logits, routing = self.model.prefill_routed(
            self.params, {"tokens": tokens}, one, self.ecfg.max_cache,
            mesh=self.mesh)
        nxt = self._sample_next(logits[:, -1], temps[slot:slot + 1],
                                topks[slot:slot + 1], step_idx)
        last_tok = self.last_tok.clone()
        last_tok[slot] = nxt[0]
        return last_tok, routing

    def _decode(self, lengths, active, temps, topks, step_idx: int):
        """Reference mode: one token for every row at position
        ``lengths``; inactive rows are dead-routed and keep ``last_tok``.
        Returns (last_tok', routing (L, B, K))."""
        self._note("decode", lengths, active, temps, topks)
        logits, routing = self.model.decode_step_routed(
            self.params, self.cache,
            {"tokens": self.last_tok[:, None], "lengths": lengths,
             "token_mask": active[:, None]}, self.ecfg.max_cache,
            mesh=self.mesh)
        rows = self.rows
        nxt = self._sample_next(logits[:, -1], temps[rows], topks[rows],
                                step_idx, rows)
        tok = torch.where(active[rows], nxt, self.last_tok[rows])
        tok, _, routing = self._gather_rows(tok, active[rows], routing)
        return tok, routing

    # -- public API ---------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0,
               priority: int = 0, deadline_ms: float | None = None) -> int:
        """Queue a request.  ``temperature``/``top_k`` select per-request
        sampling (greedy when temperature == 0).  The unified step streams
        prompts of up to ``max_cache`` tokens through the cache in chunks;
        the reference engine pads prompts to ``prefill_len`` and refuses
        longer ones (it never truncates).

        ``priority`` orders admission (higher first, FIFO within a class;
        under ``overcommit`` a higher-priority arrival may preempt
        strictly-lower-priority running rows).  ``deadline_ms`` is a
        wall-clock budget from submit: a request still unfinished when it
        elapses is expired and its pages released."""
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) == 0:
            # a zero-length prompt would be scheduled as a decode row seeded
            # from the slot's stale last token
            raise ValueError("empty prompt")
        limit = (self.ecfg.max_cache if self.unified
                 else self.ecfg.prefill_len)
        if len(prompt) > limit:
            mode = "unified" if self.unified else "reference"
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the {mode} "
                f"engine's limit of {limit} "
                f"({'max_cache' if self.unified else 'prefill_len'}); "
                f"refusing to silently truncate")
        # the reference path always decodes from offset prefill_len
        context = len(prompt) if self.unified else self.ecfg.prefill_len
        if context + max_new_tokens - 1 > self.ecfg.max_cache:
            raise ValueError(
                f"context of {context} tokens + {max_new_tokens} new "
                f"tokens does not fit the {self.ecfg.max_cache}-slot cache; "
                f"lower max_new_tokens or raise max_cache")
        if self.paged:
            blocks = -(-(context + max_new_tokens - 1) // self.page_size)
            if blocks > self.block_pages:
                raise ValueError(
                    f"request needs {blocks} pages but the pool holds only "
                    f"{self.block_pages}; raise num_pages or lower "
                    f"max_new_tokens")
        self._uid += 1
        self._seq += 1
        if temperature > 0:
            self._sampling = True     # the sort and the draws from now on
        now = time.perf_counter()
        # on a mesh a deadline runs on rank 0's clock (``_now``)
        start = (self._now() if self.mesh is not None
                 and deadline_ms is not None else now)
        req = Request(self._uid, prompt, max_new_tokens,
                      temperature=float(temperature), top_k=int(top_k),
                      priority=int(priority), submit_s=now, seq=self._seq,
                      deadline_s=(start + deadline_ms / 1e3
                                  if deadline_ms is not None else None))
        self.queue.append(req)
        self._all[req.uid] = req
        return self._uid

    def step(self) -> int:
        """One engine iteration: expire requests past their deadline, then
        (unified) admit, host state only, and pack decode rows and prefill
        chunks into one device step, or (reference) admit with separate
        prefill calls that stall in-flight rows, then decode every active
        row by one token.  Returns the number of rows that did work.  In
        async mode the step is only dispatched; tokens reach requests at
        the next harvest."""
        self._iter += 1
        self._sweep_deadlines()
        if self.unified:
            return self._step_unified()
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        b = self.ecfg.max_batch
        mask = np.zeros((b,), bool)
        mask[active] = True
        t0 = time.perf_counter()
        step_idx = self._next_step_idx()
        d_len, d_mask, d_temp, d_topk = self._upload(
            self.lengths, mask, self.temps, self.topks)
        self.last_tok, routing = self._decode(d_len, d_mask != 0, d_temp,
                                              d_topk, step_idx)
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self._pending.append(_Pending(
            "decode", tuple((i, self.slots[i]) for i in active),
            self.last_tok, routing, tuple(active), b))
        finishing = False
        for i in active:
            self.lengths[i] = min(self.lengths[i] + 1, self.ecfg.max_cache)
            self.stats["decode_tokens"] += 1
            self.budgets[i] -= 1
            if self.budgets[i] <= 0:
                # budget-based completion is host-known at dispatch: free
                # the slot now, collect the tokens at the harvest below
                self._finish_slot(i)
                finishing = True
        if finishing or not self.ecfg.async_steps:
            self._harvest()
        return len(active)

    # -- the reference engine's admission -----------------------------------

    def _pad_prompt(self, req: Request) -> np.ndarray:
        """The prompt zero-padded to ``prefill_len`` (enforced at submit)."""
        pad = np.zeros((self.ecfg.prefill_len,), np.int32)
        pad[:len(req.prompt)] = req.prompt
        return pad

    def _admit(self) -> None:
        free = [i for i, r in enumerate(self.slots) if r is None]
        if not free or not self.queue:
            return
        # every in-flight decode row sits idle for the whole separate
        # prefill call (the unified step has no such window)
        self._admit_stalled = any(r is not None for r in self.slots)
        if self.ecfg.batched_prefill:
            self._admit_batched(free)
        else:
            self._admit_sequential(free)

    def _post_admit(self, rows, routing, obs_rows: tuple,
                    routing_batch: int) -> None:
        """Bind each admitted (slot, request): it decodes from position
        ``prefill_len`` with its first token already sampled."""
        for slot, req in rows:
            self.slots[slot] = req
            self.slot_ctx[slot] = req.prompt
            req.status = "running"
            self.lengths[slot] = self.ecfg.prefill_len
            self.budgets[slot] = req.max_new_tokens - 1
            # real prompt tokens, and the padding the fixed-length call
            # computes anyway
            self.stats["prefill_tokens"] += len(req.prompt)
            self.stats["prefill_pad_tokens"] += (self.ecfg.prefill_len
                                                 - len(req.prompt))
        self._pending.append(_Pending("prefill", tuple(rows), self.last_tok,
                                      routing, obs_rows, routing_batch,
                                      stalled=self._admit_stalled))
        if not self.ecfg.async_steps:
            self._harvest()

    def _timed_prefill(self, fn, *args) -> Any:
        """Dispatch one prefill call, charging its time to ``prefill_s``
        (and ``stall_s`` when decode rows are in flight); returns the
        routing capture."""
        t0 = time.perf_counter()
        self.last_tok, routing = fn(*args, self._next_step_idx())
        dt = time.perf_counter() - t0
        self.stats["prefill_s"] += dt
        if self._admit_stalled:
            self.stats["stall_s"] += dt
        return routing

    def _admit_batched(self, free: list[int]) -> None:
        b = self.ecfg.max_batch
        rows = []
        tokens = np.zeros((b, self.ecfg.prefill_len), np.int32)
        admit = np.zeros((b,), bool)
        for slot in free:
            if not self.queue:
                break
            req = self.queue.popleft()
            tokens[slot] = self._pad_prompt(req)
            admit[slot] = True
            self.temps[slot] = req.temperature
            self.topks[slot] = req.top_k
            rows.append((slot, req))
        d_tok, d_admit, d_temp, d_topk = self._upload(
            tokens, admit, self.temps, self.topks)
        routing = self._timed_prefill(self._prefill_batch, d_tok,
                                      d_admit != 0, d_temp, d_topk)
        self._post_admit(rows, routing, tuple(s for s, _ in rows), b)

    def _admit_sequential(self, free: list[int]) -> None:
        for slot in free:
            if not self.queue:
                break
            # re-checked per call: request N's prefill stalls the requests
            # admitted earlier in this round too
            self._admit_stalled = any(r is not None for r in self.slots)
            req = self.queue.popleft()
            self.temps[slot] = req.temperature
            self.topks[slot] = req.top_k
            d_tok, d_temp, d_topk = self._upload(
                self._pad_prompt(req)[None], self.temps, self.topks)
            routing = self._timed_prefill(self._prefill_one, d_tok, slot,
                                          d_temp, d_topk)
            self._post_admit([(slot, req)], routing, (0,), 1)

    def _next_step_idx(self) -> int:
        """Monotone per-dispatch counter keying the sampler's draws."""
        i = self._step_idx
        self._step_idx += 1
        return i

    def _step_unified(self) -> int:
        """One token-budget iteration: (a) every decode row, one token each,
        exempt from the budget; (b) pending prefill chunks, lowest slot
        first, until ``token_budget`` (0 = unlimited) is spent.  A row whose
        chunk completes its prompt samples its first token from that
        chunk's last logit.

        Resilience hooks: decode rows secure the page their next token
        writes BEFORE anything is scheduled (lazy growth under overcommit;
        a row that cannot get one idles this iteration or preempts a
        peer); an injected dispatch fault aborts the iteration before any
        host bookkeeping mutates, so the identical iteration re-dispatches
        next step; with the NaN guard on, rows whose logits came back
        non-finite are withheld from every host-state advance and retried
        from their last durable cache state (the repeated pool writes are
        idempotent, so neighbours never see the fault)."""
        b, t = self.ecfg.max_batch, self.chunk_len
        full = set()            # data blocks whose pool refused the head
        for i in range(b):
            if self.slots[i] is None and self.queue:
                if self.paged:
                    # page-gated admission in priority order: the head
                    # waits for the first free slot whose block's pool can
                    # hold it; stop once no block can (never skip ahead)
                    if self._block(i) in full:
                        continue
                    if not self._admit_paged(i):
                        full.add(self._block(i))
                        if len(full) == self.blocks:
                            break
                    continue
                self._admit_slot(i)
        self.stats["active_hwm"] = max(
            self.stats["active_hwm"],
            sum(1 for s in self.slots if s is not None))
        # lazy-growth pass: every decode-phase row secures its next page
        # before any row is scheduled — growth may preempt a peer (or the
        # grower), and a preempted row must not already be in the block
        for i in range(b):
            if (self.paged and self.slots[i] is not None
                    and self.prefill_pos[i] >= len(self.slot_ctx[i])):
                self._ensure_decode_page(i)
        tokens = np.zeros((b, t), np.int32)
        seg = np.zeros((b,), np.int32)
        is_dec = np.zeros((b,), bool)
        sample = np.zeros((b,), bool)
        budget = self.ecfg.token_budget or (b * t + b)   # 0 = unlimited
        decode_rows, prefill_rows = [], []
        for i, req in enumerate(self.slots):
            if (req is not None
                    and self.prefill_pos[i] >= len(self.slot_ctx[i])
                    and (not self.paged or self._covered(i))):
                # (an uncovered row is page-starved: it idles this
                # iteration with its state intact and retries next step)
                seg[i] = 1
                is_dec[i] = sample[i] = True
                decode_rows.append(i)   # budget-exempt: decode never starves
        for i, req in enumerate(self.slots):
            if req is None or is_dec[i] or budget <= 0:
                continue
            ctx = self.slot_ctx[i]
            pos = int(self.prefill_pos[i])
            n = min(t, len(ctx) - pos, budget,
                    self.ecfg.max_cache - int(self.lengths[i]))
            if n <= 0:
                continue
            tokens[i, :n] = ctx[pos:pos + n]
            seg[i] = n
            budget -= n
            sample[i] = pos + n == len(ctx)
            prefill_rows.append(i)
        if not decode_rows and not prefill_rows:
            return 0
        # decode-only iterations shrink the block to width 1: the step is
        # length-agnostic, so the steady-state decode iteration costs a
        # decode step, never chunk_len columns of dead compute
        if not prefill_rows:
            tokens = tokens[:, :1]
        # the poison vector exists only in a step a NaN fault fires in;
        # every other step uploads and applies none
        poison = None
        if self.faults is not None:
            f = self.faults.poll(self._iter, "nan")
            if f is not None:
                poison = np.zeros((b,), np.float32)
                poison[list(f.rows) if f.rows else range(b)] = f.value
            try:
                # raised in place of the backend refusing the launch:
                # nothing host-side has mutated yet (not even the sampler's
                # step index), so the identical iteration re-dispatches on
                # the next step().  Only an injected fault is caught
                self.faults.maybe_raise(self._iter, "dispatch")
            except InjectedFault:
                self.stats["dispatch_failures"] += 1
                return 0
        t0 = time.perf_counter()
        step_idx = self._next_step_idx()
        tables = (self.block_tables,) if self.paged else ()
        d_tok, d_len, d_seg, d_dec, d_sample, d_temp, d_topk, *rest = \
            self._upload(tokens, self.lengths, seg, is_dec, sample,
                         self.temps, self.topks, *tables,
                         *(() if poison is None else (poison,)))
        d_bt = rest.pop(0) if self.paged else None
        self.last_tok, routing, bad = self._unified(
            d_tok, d_len, d_seg, d_bt, d_dec != 0, d_sample != 0, d_temp,
            d_topk, rest[0] if rest else None, step_idx)
        dt = time.perf_counter() - t0
        kind = ("decode" if not prefill_rows
                else "prefill" if not decode_rows else "mixed")
        self.stats[kind + "_s"] += dt
        if kind == "mixed":
            self.stats["mixed_decode_tokens"] += len(decode_rows)
            self.stats["mixed_prefill_tokens"] += int(
                sum(int(seg[i]) for i in prefill_rows))
        bad_host = (self._quarantine_check(bad) if self.faults is not None
                    else np.zeros((b,), bool))
        rows = []
        finishing = False
        for i in decode_rows:
            if bad_host[i]:
                finishing |= self._quarantine(i)
                continue
            self.slots[i].nan_retries = 0
            self.lengths[i] = min(self.lengths[i] + 1, self.ecfg.max_cache)
            self.stats["decode_tokens"] += 1
            self.budgets[i] -= 1
            rows.append((i, self.slots[i]))
            if self.budgets[i] <= 0:
                self._finish_slot(i)
                finishing = True
        if decode_rows:
            self.stats["decode_steps"] += 1
        for i in prefill_rows:
            if bad_host[i]:
                finishing |= self._quarantine(i)
                continue
            self.slots[i].nan_retries = 0
            n = int(seg[i])
            self.lengths[i] += n
            self.prefill_pos[i] += n
            self.stats["prefill_tokens"] += n
            if sample[i]:                 # prompt complete: token 1 sampled
                # the prompt's pages are final from this dispatch on: cache
                # them for prefix reuse BEFORE any release
                if self.paged:
                    self._prefix_insert(i)
                rows.append((i, self.slots[i]))
                self.budgets[i] -= 1
                if self.budgets[i] <= 0:
                    self._finish_slot(i)
                    finishing = True
        self._pending.append(_Pending(
            kind, tuple(rows), self.last_tok, routing,
            obs_rows=tuple(i for i in range(b)
                           if seg[i] and not bad_host[i]), routing_batch=b))
        if finishing or not self.ecfg.async_steps:
            self._harvest()
        return len(decode_rows) + len(prefill_rows)

    def _admit_slot(self, slot: int) -> None:
        """Contiguous-cache admission: bind the queue head to ``slot``; its
        prompt streams into the slot's row from position 0."""
        req = self.queue.popleft()
        self.slots[slot] = req
        self.slot_ctx[slot] = req.prompt
        req.status = "running"
        self.lengths[slot] = 0
        self.prefill_pos[slot] = 0
        self.budgets[slot] = req.max_new_tokens
        self.temps[slot] = req.temperature
        self.topks[slot] = req.top_k

    # -- paged-cache bookkeeping -------------------------------------------

    def _admit_paged(self, slot: int) -> bool:
        """Map the queue head into ``slot`` if the pool can hold its page
        entitlement, minus every page shared through the prefix cache.

        Entitlement: the whole lifetime — ceil((context + remaining_new -
        1) / page_size) pages — by default, so an admitted request never
        runs out of pages mid-generation; under ``overcommit`` only the
        CONTEXT's pages, and ``_ensure_decode_page`` grows the rest one
        page at a time.

        Restore is the same operation: a preempted request's
        ``resume_tokens`` (prompt + everything generated before the
        preemption) is its context and its own pages in the prefix tree
        are the hit, so restore is a block-table remap plus at most one
        partial-tail re-prefill chunk.  Under overcommit a short pool
        preempts strictly-lower-priority running rows until the head fits
        or nobody lesser remains.

        Returns False with the queue untouched when pages stay short after
        LRU eviction and preemption.  The pool, the prefix tree and the
        preemption victims are the slot's data block's."""
        req = self.queue[0]
        alloc, prefix = self._pool(slot)
        if self.faults is not None and self.faults.poll(self._iter, "alloc"):
            # injected pool exhaustion: nothing free, nothing reclaimable
            # this iteration; the request stays queued (no refcount taken)
            self.stats["alloc_stalls"] += 1
            return False
        ctx = (req.resume_tokens if req.resume_tokens is not None
               else req.prompt)
        remaining = req.max_new_tokens - len(req.generated)
        lifetime = sched.lifetime_pages(len(ctx), remaining, self.page_size)
        upfront = (sched.pages_for(len(ctx), self.page_size)
                   if self.ecfg.overcommit else lifetime)
        hit = prefix.lookup(ctx)
        need = upfront - len(hit.pages)
        if alloc.free_pages < need:
            # evict only when it can close the gap: a request merely
            # waiting for in-flight pages must not drain the tree
            if alloc.free_pages + prefix.reclaimable_pages() >= need:
                prefix.evict(need)
        while alloc.free_pages < need and self.ecfg.overcommit:
            # priority preemption: a victim's pages land in the prefix tree
            # (reclaimable once its row references drop), so each
            # preemption is followed by another gap-closing eviction
            victim = sched.select_victim(self._running_rows(slot),
                                         below=req.priority)
            if victim is None:
                break
            self._preempt_slot(victim)
            if alloc.free_pages + prefix.reclaimable_pages() >= need:
                prefix.evict(need)
        if alloc.free_pages < need:
            # hand the lookup references back; the request stays queued
            alloc.free(hit.pages)
            if hit.tail_page >= 0:
                alloc.free([hit.tail_page])
            return False
        self.stats["prefix_lookups"] += 1
        new_pages = alloc.alloc(need)
        pages = list(hit.pages) + new_pages
        if hit.tail_len:
            # copy-on-write the shared partial tail page: its owner may
            # still append decode tokens to the original
            self._copy_pages([hit.tail_page], [new_pages[0]],
                             self._block(slot))
            alloc.free([hit.tail_page])   # drop the lookup ref
            self.stats["cow_copies"] += 1
        self.queue.popleft()
        self.slots[slot] = req
        self.slot_ctx[slot] = ctx
        self.slot_pages[slot] = pages
        self.block_tables[slot] = 0
        self.block_tables[slot, :len(pages)] = pages
        # the shared prefix is already in the cache: prefill starts there
        self.lengths[slot] = hit.tokens
        self.prefill_pos[slot] = hit.tokens
        self.budgets[slot] = remaining
        self.temps[slot] = req.temperature
        self.topks[slot] = req.top_k
        if req.status == "preempted":
            self.stats["restores"] += 1
            self.stats["restore_hit_tokens"] += hit.tokens
        req.status = "running"
        if hit.tokens:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += hit.tokens
        self._note_pages()
        return True

    def _block(self, i: int) -> int:
        """The data block slot ``i`` belongs to."""
        return i // self.block_rows

    def _mine(self, i: int) -> bool:
        """Whether slot ``i``'s row is this rank's (its cache here)."""
        return self.rows.start <= i < self.rows.stop

    def _pool(self, i: int) -> tuple:
        """(allocator, prefix tree) of slot ``i``'s data block."""
        blk = self._block(i)
        return self.allocators[blk], self.prefixes[blk]

    def _note_pages(self) -> None:
        self.stats["pages_hwm"] = max(
            self.stats["pages_hwm"],
            sum(a.pages_in_use for a in self.allocators))

    def _covered(self, i: int) -> bool:
        """Row ``i``'s next decode write (cache position ``lengths[i]``)
        has a page under its block table."""
        return int(self.lengths[i]) < len(self.slot_pages[i]) * self.page_size

    def _running_rows(self, slot: int) -> list:
        """Victim candidates for ``sched.select_victim``: every occupied
        slot of slot ``slot``'s data block (whose pool a preemption
        refills) with its scheduling keys."""
        blk = self._block(slot)
        return [sched.RunningRow(i, r.priority, r.last_preempt_epoch, r.seq)
                for i, r in enumerate(self.slots)
                if r is not None and self._block(i) == blk]

    def _ensure_decode_page(self, i: int) -> bool:
        """Lazy decode-page growth: make sure row ``i``'s block table
        covers the position its next token writes.

        Whole-lifetime admission always covers it.  An overcommitted row
        takes one page at a time: evict LRU prefix entries if that closes
        the gap; if the pool is still dry, preempt the least-entitled
        running row — possibly row ``i`` itself, which then yields.
        Returns False when the row cannot advance this iteration
        (preempted, or page-starved under an injected alloc fault).  The
        pool and the victims are row ``i``'s data block's."""
        if self._covered(i):
            return True
        alloc, prefix = self._pool(i)
        if self.faults is not None and self.faults.poll(self._iter, "alloc"):
            self.stats["alloc_stalls"] += 1
            return False
        if (alloc.free_pages < 1
                and alloc.free_pages + prefix.reclaimable_pages() >= 1):
            prefix.evict(1)
        while alloc.free_pages < 1 and self.ecfg.overcommit:
            victim = sched.select_victim(self._running_rows(i))
            if victim is None:
                break
            self._preempt_slot(victim)
            if victim == i:
                return False
            if alloc.free_pages + prefix.reclaimable_pages() >= 1:
                prefix.evict(1)
        got = alloc.alloc(1)
        if got is None:
            self.stats["alloc_stalls"] += 1
            return False
        self.slot_pages[i].append(got[0])
        self.block_tables[i, len(self.slot_pages[i]) - 1] = got[0]
        self._note_pages()
        return True

    def _preempt_slot(self, i: int) -> None:
        """Evict row ``i`` to the prefix cache and requeue its request.

        Order matters: (1) harvest (a device sync), so every in-flight
        token of the row is on the host and the virtual prompt (prompt +
        generated) is final; (2) insert the row's durable cache state —
        ``lengths[i]`` tokens: every full page plus the partial tail —
        into the prefix tree; (3) free the row's own page references (the
        tree's keep the state alive, LRU-evictable); (4) requeue with
        ``resume_tokens`` = the virtual prompt and the ORIGINAL submission
        seq.  Restore (``_admit_paged``) then finds its own pages as a
        prefix hit and re-prefills at most one partial chunk."""
        self._harvest()
        alloc, prefix = self._pool(i)
        req = self.slots[i]
        full = np.concatenate([req.prompt,
                               np.asarray(req.generated, np.int32)])
        n = int(self.lengths[i])
        ps = self.page_size
        k, tail = n // ps, n % ps
        pages = self.slot_pages[i]
        if n:
            prefix.insert(full[:n], pages[:k], pages[k] if tail else -1,
                          tail)
        alloc.free(pages)
        self.slot_pages[i] = []
        self.block_tables[i] = 0
        self.slots[i] = None
        self.slot_ctx[i] = None
        self._preempt_epoch += 1
        req.resume_tokens = full
        req.status = "preempted"
        req.preemptions += 1
        req.last_preempt_epoch = self._preempt_epoch
        self.stats["preemptions"] += 1
        self.preempt_log.append(
            (self._iter, req.uid,
             tuple((r.uid, r.priority) for r in self.slots
                   if r is not None)))
        self.queue.append(req)

    def preempt(self, uid: int) -> bool:
        """Preempt the running request ``uid`` now (a policy hook): its
        pages move into the prefix tree and it restores through normal
        admission.  Returns False if ``uid`` is not in a slot."""
        for i, r in enumerate(self.slots):
            if r is not None and r.uid == uid:
                self._preempt_slot(i)
                return True
        return False

    def _release_slot(self, i: int) -> None:
        """Free slot ``i``'s page references and binding (exactly once: the
        page list is emptied); pages the prefix tree also holds stay
        resident for future hits."""
        if self.paged and self.slot_pages[i]:
            self._pool(i)[0].free(self.slot_pages[i])
            self.slot_pages[i] = []
            self.block_tables[i] = 0
        self.slots[i] = None
        self.slot_ctx[i] = None

    def _finish_slot(self, i: int) -> None:
        """Normal completion: the budget is spent and the final token is in
        flight to the harvest (which flips ``done``)."""
        req = self.slots[i]
        if req.status == "running":
            req.status = "done"
        self._release_slot(i)

    def _prefix_insert(self, i: int) -> None:
        """Record row ``i``'s freshly prefilled context in the prefix tree:
        full page-aligned chunks become radix nodes, a non-aligned remainder
        the node's partial-tail record (shareable via copy-on-write).  A
        restored request's context is its ``resume_tokens``."""
        ctx = self.slot_ctx[i]
        ps = self.page_size
        k = len(ctx) // ps
        pages = [int(p) for p in self.block_tables[i, :k]]
        tail_len = len(ctx) - k * ps
        tail_page = int(self.block_tables[i, k]) if tail_len else -1
        self._pool(i)[1].insert(ctx, pages, tail_page, tail_len)

    # -- cancellation, deadlines, quarantine --------------------------------

    def _terminate_req(self, req: Request, status: str) -> None:
        """Move ``req`` to a terminal state (its pages already released);
        ``done`` flips so waiters see it finished, ``status`` says why."""
        req.status = status
        req.done = True
        self.stats[status] += 1

    def _terminate_slot(self, i: int, status: str) -> None:
        req = self.slots[i]
        self._release_slot(i)
        self._terminate_req(req, status)

    def cancel(self, uid: int) -> bool:
        """Abandon request ``uid``, queued or in flight.  Only the row's
        page references are dropped, exactly once; pages the prefix tree
        shares stay cached.  In-flight tokens are harvested first (a device
        sync), so ``generated`` holds everything produced before the
        cancel.  Returns True if the request was live and is now
        cancelled; False if unknown or already terminal."""
        req = self._all.get(uid)
        if req is None or req.done or req.status in TERMINAL_STATES:
            return False
        # a record in flight may complete the request (then the cancel is
        # too late), and the bookkeeping below needs ``generated`` final
        self._harvest()
        if req.done:
            return False
        if self.queue.remove(uid) is not None:      # queued or preempted
            self._terminate_req(req, "cancelled")
            return True
        for i, r in enumerate(self.slots):
            if r is not None and r.uid == uid:
                self._terminate_slot(i, "cancelled")
                return True
        return False

    def _sweep_deadlines(self) -> None:
        """Expire every request whose deadline passed (at the top of each
        step; ``_now`` is patchable in tests).  Queued requests just leave
        the queue; in-flight rows harvest (a device sync) and release their
        pages through the same exactly-once path as cancel.  On a mesh the
        clock is read (a broadcast) only while some request has a
        deadline, which every rank's host state agrees on."""
        if self.mesh is not None and not any(
                r is not None and r.deadline_s is not None
                for r in list(self.queue) + self.slots):
            return
        now = self._now()
        for r in list(self.queue):
            if r.deadline_s is not None and now >= r.deadline_s:
                if self.queue.remove(r.uid) is not None:
                    self._terminate_req(r, "expired")
        for i, req in enumerate(self.slots):
            if (req is not None and req.deadline_s is not None
                    and now >= req.deadline_s):
                self._harvest()
                if not req.done:
                    self._terminate_slot(i, "expired")

    def _clock(self) -> float:
        return time.perf_counter()

    def _now(self) -> float:
        """The deadlines' clock: this process's, or on a mesh rank 0's,
        broadcast along every axis so that each rank expires the same
        requests at the same step."""
        if self.mesh is None:
            return self._clock()
        t = torch.tensor([self._clock()], dtype=torch.float64)
        for axis in self.mesh.axis_names:
            t = collectives.broadcast(t, self.mesh, axis)
        return float(t[0])

    def _quarantine(self, i: int) -> bool:
        """Row ``i``'s logits came back non-finite: withhold every
        host-state advance so the row re-dispatches from its last durable
        cache state (the repeated pool write is idempotent; on the device
        ``last_tok`` was already shielded).  After ``NAN_RETRY_LIMIT``
        consecutive bad steps the row is failed and its pages released.
        Returns True when the row was failed (a harvest boundary)."""
        req = self.slots[i]
        self.stats["nan_quarantines"] += 1
        req.nan_retries += 1
        if req.nan_retries > NAN_RETRY_LIMIT:
            self._terminate_slot(i, "failed")
            return True
        return False

    def _quarantine_check(self, bad: torch.Tensor) -> np.ndarray:
        """THE quarantine sync point (on while a fault plan is installed):
        the step's per-row finiteness verdict, read once as numpy.  A
        deliberate per-step device-to-host read, the guard's trade of
        run-ahead for per-step integrity, like ``async_steps=False``."""
        return bad.cpu().numpy()

    # -- reporting ----------------------------------------------------------

    def resilience_stats(self) -> dict:
        """Scheduler and fault-guard counters (launcher, chaos matrix)."""
        s = self.stats
        out = {k: s[k] for k in
               ("preemptions", "restores", "restore_hit_tokens",
                "cancelled", "expired", "failed", "alloc_stalls",
                "dispatch_failures", "nan_quarantines", "active_hwm")}
        out["preempt_log_len"] = len(self.preempt_log)
        return out

    def paged_stats(self) -> dict:
        """Page-pool / prefix-cache counters; ``{"paged": False}`` on the
        contiguous cache."""
        if not self.paged:
            return {"paged": False}
        s = self.stats
        return {
            "paged": True,
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "data_blocks": self.blocks,
            "pages_in_use": sum(a.pages_in_use for a in self.allocators),
            "pages_hwm": s["pages_hwm"],
            "pool_utilization": s["pages_hwm"] / self.num_pages,
            "prefix_lookups": s["prefix_lookups"],
            "prefix_hits": s["prefix_hits"],
            "prefix_hit_rate": s["prefix_hits"] / max(s["prefix_lookups"], 1),
            "prefix_hit_tokens": s["prefix_hit_tokens"],
            "prefix_cached_pages": sum(p.cached_pages for p in self.prefixes),
            "prefix_evictions": sum(p.evictions for p in self.prefixes),
            "cow_copies": s["cow_copies"],
        }

    def memory_stats(self) -> dict:
        """Device bytes of the weights and the KV cache (QuantTensor leaves
        count payload plus scales, an int8 cache its scales)."""
        weight = quant.tree_bytes(self.params)
        pool = quant.tree_bytes(self.cache)
        return {"weight_bytes": weight, "kv_pool_bytes": pool,
                "total_bytes": weight + pool,
                "weight_quant": self.cfg.weight_quant}

    # -- harvest: the loop's sync point ---------------------------------------

    def _harvest(self) -> None:
        """Fetch every pending step's tokens (and routing) and apply them to
        requests and the tracker in dispatch order.  Each record is fetched
        with its own timed copy: steps complete in dispatch order, so the
        per-record wait is that step's remaining device time."""
        if not self._pending:
            return
        recs, self._pending = self._pending, []
        for rec in recs:
            t0 = time.perf_counter()
            tok = rec.tok.cpu().numpy()
            routing = (rec.routing.cpu().numpy() if self.tracker is not None
                       else None)
            now = time.perf_counter()
            self.stats[rec.kind + "_s"] += now - t0
            if rec.stalled:
                self.stats["stall_s"] += now - t0
            for slot, req in rec.rows:
                req.generated.append(int(tok[slot]))
                if req.first_token_s is None:
                    req.first_token_s = now
                if len(req.generated) >= req.max_new_tokens:
                    req.done = True
                    if req.status not in TERMINAL_STATES:
                        req.status = "done"
            self._observe_routing(rec, routing)

    def _observe_routing(self, rec: _Pending, routing) -> None:
        """Feed the tracker from the device capture (no host routing)."""
        if self.tracker is None:
            return
        per_row = routing.reshape(routing.shape[0], rec.routing_batch, -1)
        for layer in range(self.cfg.num_layers):
            ids = per_row[layer, list(rec.obs_rows)]
            # dead-routed invalid tokens read the E_pad sentinel: padding,
            # not executed experts
            self.tracker.observe(layer, ids[ids < self.cfg.num_experts])
        self.tracker.tick()

    def flush(self) -> None:
        """Sync: harvest every dispatched-but-unapplied step."""
        self._harvest()

    def run_until_done(self, max_steps: int = 10_000) -> list[Request]:
        done: list[Request] = []
        seen: set[int] = set()
        pending = lambda: self.queue or any(s is not None for s in self.slots)
        steps = 0
        while pending() and steps < max_steps:
            self.step()
            steps += 1
            for r in self._all.values():
                if r.done and r.uid not in seen:
                    seen.add(r.uid)
                    done.append(r)
        self.flush()
        for r in self._all.values():
            if r.done and r.uid not in seen:
                seen.add(r.uid)
                done.append(r)
        return done

    # -- paper policy artifacts ---------------------------------------------

    def standby(self) -> torch.Tensor:
        """The paper's between-request keep-warm (§4.2 'standby
        calculation'): a summing touch over every expert weight, in fp32.
        A QuantTensor leaf contributes its payload and its fp32 scales, the
        leaves the reference's tree walk yields.  Summed one layer at a
        time, so an int8 payload's fp32 copy is one layer's slice (bf16
        sums on the card cast as they read)."""
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        if not self.cfg.is_moe:
            return total
        ex = self.params["blocks"]["experts"]
        for name in sorted(ex):
            w = ex[name]
            for leaf in ((w.data, w.scale) if isinstance(w, quant.QuantTensor)
                         else (w,)):
                for layer in leaf:
                    total += layer.sum(dtype=torch.float32)
        return total

    def expected_experts_per_node(self, n_nodes: int) -> float:
        """The paper's Table-1 statistic E[#exec experts/node/layer] from the
        device-captured routing of every served step."""
        if self.tracker is None:
            return float("nan")
        self.flush()
        return self.tracker.mean_executed_per_node(n_nodes)

    def throughput(self) -> dict:
        """Per-phase tok/s.  ``*_s`` hold dispatch time plus each phase's
        harvest wait; mixed-iteration time is apportioned between the two
        phases by their token share of those iterations.  Prefill counts
        real prompt tokens; ``prefill_padding_overhead`` is the share of
        prefill positions the reference engine spent on padding and
        ``decode_stall_s`` the time its decode rows waited behind a
        prefill call (both 0 on the unified step)."""
        s = self.stats
        pad = s["prefill_pad_tokens"]
        work_s = s["prefill_s"] + s["decode_s"] + s["mixed_s"]
        mp, md = s["mixed_prefill_tokens"], s["mixed_decode_tokens"]
        p_share = mp / (mp + md) if (mp + md) else 0.0
        prefill_den = s["prefill_s"] + s["mixed_s"] * p_share
        decode_den = s["decode_s"] + s["mixed_s"] * (1.0 - p_share)
        return {
            "prefill_tok_per_s": s["prefill_tokens"] / max(prefill_den, 1e-9),
            "decode_tok_per_s": s["decode_tokens"] / max(decode_den, 1e-9),
            "total_tok_per_s": (s["prefill_tokens"] + s["decode_tokens"])
                               / max(work_s, 1e-9),
            "prefill_padding_overhead": pad / max(pad + s["prefill_tokens"],
                                                  1),
            "decode_stall_s": s["stall_s"],
        }

    def ttft(self, since: float = 0.0) -> dict:
        """Time-to-first-token over completed requests (seconds, at harvest
        resolution: pair with ``async_steps=False`` when TTFT is the metric
        under study).  ``since`` drops requests submitted before that
        ``time.perf_counter()`` stamp."""
        ts = sorted(r.first_token_s - r.submit_s for r in self._all.values()
                    if r.first_token_s is not None and r.submit_s >= since)
        if not ts:
            return {"n": 0, "p50": float("nan"), "p95": float("nan")}
        pct = lambda p: ts[min(int(p * (len(ts) - 1) + 0.5), len(ts) - 1)]
        return {"n": len(ts), "p50": pct(0.50), "p95": pct(0.95),
                "mean": sum(ts) / len(ts)}
