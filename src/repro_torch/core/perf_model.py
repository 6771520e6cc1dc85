"""The paper's analytical performance model (§4.4, Eq. 1), generalized: the
port's copy of the JAX package's ``core/perf_model.py`` (stdlib and numpy;
it reads only config fields).

Per-token lower-bound inference time for an expert-parallel MoE system:

    T = max(bytes_loaded / mem_bw, FLOPs / peak_flops)        (GPU term)
      + n_layers * comm_latency + comm_bytes / comm_bw        (comm term)

The module reproduces Table 1 (DBRX variable derivations), Table 6
(estimated bounds for 2–8 Mac Studio nodes over 10 GbE), Fig. 8's RDMA NIC
projections, and Table 5's cost-efficiency comparison.  Beyond the paper,
``estimate(..., microchunks=m)`` extends Eq. (1) with a comm/compute
overlap term modelling the ``a2a_pipelined`` schedule: serial gpu+comm
becomes the pipelined bound m·latency + max(gpu, transfer) +
min(gpu, transfer)/m; and ``mixed_step_estimate``/``chunked_prefill_ttft``
model the unified mixed prefill/decode iteration with a ``chunk_len`` knob
— the prefill chunk rides on expert weights the decode rows already load,
so interleaving is nearly free in the load-bound regime while smaller
chunks add latency rounds.  The weight-byte model (``model_weight_bytes``)
is exact against ``ServingEngine.memory_stats()["weight_bytes"]``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    mem_bw: float              # bytes/sec per node
    peak_flops: float          # FLOP/s per node (bf16)
    comm_latency: float        # sec per communication round
    comm_bw: float             # bytes/sec
    price_per_node: float = 0.0  # USD


# paper Table 1 / Table 2 / §5.5 footnotes
M2_ULTRA_10GBE = HardwareProfile(
    "mac-studio-10gbe", mem_bw=800e9, peak_flops=54e12,
    comm_latency=1e-3, comm_bw=1.25e9, price_per_node=6599.0)
M2_ULTRA_ROCE = HardwareProfile(
    "mac-studio-rocev2", mem_bw=800e9, peak_flops=54e12,
    comm_latency=750e-9, comm_bw=25e9 / 8, price_per_node=6599.0 + 339.0)
M2_ULTRA_IB = HardwareProfile(
    "mac-studio-infiniband", mem_bw=800e9, peak_flops=54e12,
    comm_latency=600e-9, comm_bw=200e9 / 8, price_per_node=6599.0 + 1267.0)
# the JAX package's target hardware (per chip)
TPU_V5E = HardwareProfile(
    "tpu-v5e", mem_bw=819e9, peak_flops=197e12,
    comm_latency=1e-6, comm_bw=50e9)
# Table 5 baseline
DGX_H100x8 = HardwareProfile(
    "dgx-8xh100", mem_bw=8 * 3.35e12, peak_flops=8 * 989e12,
    comm_latency=2e-6, comm_bw=450e9, price_per_node=289_000.0)


@dataclasses.dataclass(frozen=True)
class MoEWorkload:
    """Per-token workload description (paper Table 1, derived from config)."""
    n_layers: int
    params_sa_bytes: float     # self-attention (+router/norm) weight bytes
    flops_sa: float
    params_expert_bytes: float # one expert's weight bytes (all layers)
    flops_expert: float
    comm_bytes: float          # all-reduce payload per token (all layers)

    @classmethod
    def from_config(cls, cfg, precision: int = 2) -> "MoEWorkload":
        """Derive Table-1-style variables from a ModelConfig (per token)."""
        d, L = cfg.d_model, cfg.num_layers
        qkv_hidden = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
        p_sa = (qkv_hidden * d + d * d_out_attn(cfg)) * L * precision
        # Table 1 footnote (c): FLOPs_SA = 2 x #Params_SA where Params_SA is
        # in BYTES — the paper's convention (14e9 for DBRX), kept verbatim
        # for fidelity; harmless since Eq. 1 is load-bound on this hardware.
        f_sa = 2.0 * p_sa
        if cfg.is_moe:
            p_e = d * cfg.d_ff * 3 * L * precision
            f_e = 2 * d * cfg.d_ff * 3 * L
        else:
            p_e, f_e = d * cfg.d_ff * 3 * L * precision, 2 * d * cfg.d_ff * 3 * L
        comm = d * 4 * L * precision
        return cls(L, p_sa, f_sa, p_e, f_e, comm)


def d_out_attn(cfg) -> int:
    return cfg.num_heads * cfg.head_dim


# paper Table 1 measured routing statistic: E[#executed experts/node/layer].
# 2/3/4 nodes are measured (Table 1); 6/8 are the values implied by Table 6's
# load column ((load*mem_bw - params_SA)/params_expert), since the paper
# extrapolates them with its overlapped expert placement.
PAPER_EXPECTED_EXPERTS = {2: 2.65, 3: 2.32, 4: 1.57, 6: 1.1125, 8: 1.0125}


def expected_experts_per_node(num_experts: int, top_k: int, n_nodes: int,
                              batch: int = 1) -> float:
    """E[#distinct local experts hit per node per layer] under uniform
    routing of ``batch`` tokens: each of the E/n local experts is selected by
    one token w.p. k/E, so hit w.p. 1-(1-k/E)^batch.  With batch=1 this is
    k/n — the analytic floor under the paper's measured values (Table 1's
    2.65/2.32/1.57 include router skew and the L_R LRU top-up)."""
    e_per_node = num_experts / n_nodes
    p_hit = 1.0 - (1.0 - top_k / num_experts) ** batch
    return e_per_node * p_hit


DBRX_TABLE1 = MoEWorkload(
    n_layers=40,
    params_sa_bytes=7e9, flops_sa=14e9,
    params_expert_bytes=16e9, flops_expert=16e9,
    comm_bytes=2e6,
)


@dataclasses.dataclass(frozen=True)
class Estimate:
    load_time: float
    compute_time: float
    latency_time: float
    transfer_time: float
    # comm/compute overlap term: >1 models the a2a_pipelined schedule
    # (core/expert_parallel), which splits the token block into m
    # microchunks and overlaps chunk i's expert FFN with chunk i+1's
    # dispatch.  Eq. (1)'s serial sum gpu + comm then becomes the two-stage
    # pipeline bound  m·latency + max(gpu, transfer) + min(gpu, transfer)/m:
    # the slower stage is exposed in full, the faster one only through its
    # un-overlapped first chunk, and every microchunk round pays the
    # per-layer collective latency.  m = 1 reproduces the paper's serial
    # Eq. (1) exactly (Tables 5/6).
    microchunks: int = 1

    @property
    def gpu_time(self) -> float:
        return max(self.load_time, self.compute_time)

    @property
    def comm_time(self) -> float:
        return self.latency_time + self.transfer_time

    @property
    def total(self) -> float:
        m = self.microchunks
        if m <= 1:
            return self.gpu_time + self.comm_time
        g, t = self.gpu_time, self.transfer_time
        return self.latency_time * m + max(g, t) + min(g, t) / m

    @property
    def throughput(self) -> float:
        return 1.0 / self.total


def estimate(w: MoEWorkload, hw: HardwareProfile, n_nodes: int,
             expected_experts: float | None = None,
             microchunks: int = 1) -> Estimate:
    """Paper Eq. (1): per-token generation lower bound on n_nodes.

    ``microchunks`` > 1 applies the a2a_pipelined overlap term (see
    ``Estimate.microchunks``); the default reproduces the paper's serial
    bound."""
    if expected_experts is None:
        expected_experts = PAPER_EXPECTED_EXPERTS.get(
            n_nodes, expected_experts_per_node(16, 4, n_nodes))
    bytes_loaded = w.params_sa_bytes + w.params_expert_bytes * expected_experts
    flops = w.flops_sa + w.flops_expert * expected_experts
    return Estimate(
        load_time=bytes_loaded / hw.mem_bw,
        compute_time=flops / hw.peak_flops,
        latency_time=hw.comm_latency * w.n_layers,
        transfer_time=w.comm_bytes / hw.comm_bw,
        microchunks=microchunks,
    )


def scaling_table(w: MoEWorkload = DBRX_TABLE1,
                  hw: HardwareProfile = M2_ULTRA_10GBE,
                  nodes: tuple = (2, 3, 4, 6, 8),
                  microchunks: int = 1) -> list[dict]:
    """Reproduces paper Table 6 (and the green triangles of Fig. 8).

    ``microchunks`` > 1 adds the a2a_pipelined overlap columns
    (``bound_s_pipelined`` / ``tokens_per_sec_pipelined``) next to the
    paper's serial bound, so Table 5/6-style estimates can model the
    overlapped schedule."""
    rows = []
    for n in nodes:
        e = estimate(w, hw, n)
        row = {
            "nodes": n, "load_s": e.load_time, "comp_s": e.compute_time,
            "lat_s": e.latency_time, "trans_s": e.transfer_time,
            "bound_s": e.total, "tokens_per_sec": e.throughput,
            # Table 6 prints Time rounded to 3 decimals and derives TP from
            # the rounded value (e.g. 3 nodes: 1/0.096 = 10.4)
            "tokens_per_sec_table6": 1.0 / round(e.total, 3),
        }
        if microchunks > 1:
            ep = dataclasses.replace(e, microchunks=microchunks)
            row["bound_s_pipelined"] = ep.total
            row["tokens_per_sec_pipelined"] = ep.throughput
        rows.append(row)
    return rows


def mixed_step_estimate(w: MoEWorkload, hw: HardwareProfile, n_nodes: int,
                        decode_rows: int, chunk_len: int,
                        num_experts: int = 16, top_k: int = 4,
                        microchunks: int = 1) -> Estimate:
    """Per-ITERATION bound for the unified mixed prefill/decode batch
    (serving/engine.py ``unified_step``): ``decode_rows`` decode tokens plus
    one ``chunk_len``-token prefill chunk share a single program.

    Eq. (1) is per *token*; a mixed iteration amortizes the weight-load
    term across all t = decode_rows + chunk_len tokens in the block — the
    expected number of DISTINCT experts touched grows sublinearly in t
    (``expected_experts_per_node`` with batch=t) while FLOPs and comm
    payload scale linearly.  This is exactly why interleaving prefill
    chunks into decode batches is nearly free on load-bound hardware (the
    paper's regime): the chunk rides on weights the decode rows already
    paid to load.  ``chunk_len=0`` recovers the decode-only iteration."""
    t = max(decode_rows + chunk_len, 1)
    per_node = expected_experts_per_node(num_experts, top_k, n_nodes,
                                         batch=t)
    bytes_loaded = w.params_sa_bytes + w.params_expert_bytes * per_node
    # Per-NODE FLOPs, matching estimate()'s Eq. (1) convention: the shared
    # layers run on every node (w.flops_sa per token), while the t*top_k
    # token-expert FFN pairs spread across the n_nodes expert shards
    # (w.flops_expert is one expert's FFN over all layers, per token)
    flops = w.flops_sa * t + w.flops_expert * top_k * t / n_nodes
    return Estimate(
        load_time=bytes_loaded / hw.mem_bw,
        compute_time=flops / hw.peak_flops,
        latency_time=hw.comm_latency * w.n_layers,
        transfer_time=w.comm_bytes * t / hw.comm_bw,
        microchunks=microchunks,
    )


def chunked_prefill_ttft(w: MoEWorkload, hw: HardwareProfile, n_nodes: int,
                         prompt_len: int, chunk_len: int,
                         decode_rows: int = 0, num_experts: int = 16,
                         top_k: int = 4) -> float:
    """Modelled time-to-first-token of a ``prompt_len`` prompt streamed in
    ``chunk_len`` chunks through iterations shared with ``decode_rows``
    in-flight decode rows: ceil(P/c) mixed iterations, the last of which
    samples token 1.  Shrinking ``chunk_len`` lowers the per-iteration
    latency decode rows see but adds iterations (each paying the per-layer
    collective latency) — the knob the unified scheduler's ``token_budget``
    exposes."""
    iters = max(-(-prompt_len // max(chunk_len, 1)), 1)
    last = prompt_len - (iters - 1) * chunk_len
    total = 0.0
    for i in range(iters):
        c = chunk_len if i < iters - 1 else last
        total += mixed_step_estimate(w, hw, n_nodes, decode_rows, c,
                                     num_experts, top_k).total
    return total


# ---------------------------------------------------------------------------
# memory-capacity term (paper Table 2's unified-memory budget) and the
# paged-KV-cache serving model (serving/engine.py, the page pool)
# ---------------------------------------------------------------------------

# paper Table 2: each Mac Studio node is an M2 Ultra with 192 GB of
# unified memory — weights, KV cache and activations share one budget,
# which is exactly why the paper pre-allocates buffers (C1) and why the
# cache layout decides max concurrency
M2_ULTRA_MEM_BYTES = 192e9

# quantized weight-store levels (core/quant.py) in
# preference order: least-lossy first
WEIGHT_QUANT_LEVELS = ("none", "int8", "int4")


# numpy knows bfloat16 only once ml_dtypes is imported, which the port
# does not need
_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def _itemsize(cfg) -> int:
    name = getattr(cfg, "param_dtype", "bfloat16")
    return _ITEMSIZE.get(name) or np.dtype(name).itemsize


def quant_matrix_bytes(k: int, n: int, *, itemsize: int,
                       quant: str = "none", block: int = 128,
                       lead: int = 1) -> float:
    """Stored bytes of ``lead`` stacked (k, n) weight matrices at a quant
    level — the analytic twin of ``core/quant.quantize``'s layout: int8
    keeps k rows of 1-byte values, int4 packs two per byte (``ceil(k/2)``
    rows), and both add one fp32 scale per ``block`` of the reduction
    axis per output column."""
    if quant == "none":
        return float(lead * k * n * itemsize)
    nb = -(-k // block)
    payload = (-(-k // 2) if quant == "int4" else k) * n
    return float(lead * (payload + nb * n * 4))


def _resolve_quant(cfg, quant, block):
    """Default quant level / block / kinds from the config's weight-store
    knobs (one resolver shared by every weight-bytes term)."""
    if quant is None:
        quant = getattr(cfg, "weight_quant", "none")
    block = block or getattr(cfg, "weight_quant_block", 128)
    kinds = tuple(getattr(cfg, "weight_quant_kinds",
                          ("attn", "mlp", "experts", "lm_head")))
    return quant, block, kinds


def _expert_layer_bytes(cfg, quant, block, kinds) -> float:
    """ONE layer's expert-stack bytes (the shardable part): the single
    source of the lead = E_padded x replication formula used by both the
    per-layer term and the per-node split."""
    eq = quant if "experts" in kinds else "none"
    p = _itemsize(cfg)
    d, f = cfg.d_model, cfg.d_ff
    lead = cfg.num_experts_padded * max(
        getattr(cfg, "expert_replication", 1), 1)
    return (2 * quant_matrix_bytes(d, f, itemsize=p, quant=eq, block=block,
                                   lead=lead)
            + quant_matrix_bytes(f, d, itemsize=p, quant=eq, block=block,
                                 lead=lead))


def weight_bytes_per_layer(cfg, *, quant: str | None = None,
                           block: int | None = None) -> float:
    """One decoder layer's stored weight bytes under the blockwise weight
    store — exact for the attention families (dense/moe/vlm/audio; the
    formula mirrors ``transformer.init_blocks`` leaf for leaf and is
    held against the port's constructed params in its tests, the same
    pattern as ``kv_bytes_per_token``).
    ``quant``/``block`` default to the config's ``weight_quant`` knobs;
    kinds follow ``cfg.weight_quant_kinds`` (router stays fp by
    default)."""
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(
            f"weight_bytes_per_layer models attention-family layers, not "
            f"{cfg.family!r}")
    quant, block, kinds = _resolve_quant(cfg, quant, block)
    p = _itemsize(cfg)
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    norm_elems = 2 * d if cfg.norm == "layernorm" else d
    total = 2 * norm_elems * p                     # ln1 + ln2
    aq = quant if "attn" in kinds else "none"
    total += quant_matrix_bytes(d, hq * hd, itemsize=p, quant=aq,
                                block=block)
    total += 2 * quant_matrix_bytes(d, hkv * hd, itemsize=p, quant=aq,
                                    block=block)
    total += quant_matrix_bytes(hq * hd, d, itemsize=p, quant=aq,
                                block=block)
    if cfg.qkv_bias:
        total += (hq + 2 * hkv) * hd * p
    if cfg.qk_norm:
        total += 2 * hd * p
    if cfg.is_moe:
        rq = quant if "router" in kinds else "none"
        total += quant_matrix_bytes(d, cfg.num_experts_padded, itemsize=p,
                                    quant=rq, block=block)
        total += _expert_layer_bytes(cfg, quant, block, kinds)
    else:
        mq = quant if "mlp" in kinds else "none"
        total += 2 * quant_matrix_bytes(d, f, itemsize=p, quant=mq,
                                        block=block)
        total += quant_matrix_bytes(f, d, itemsize=p, quant=mq, block=block)
    return total


def expert_weight_bytes(cfg, *, quant: str | None = None,
                        block: int | None = None) -> float:
    """All layers' expert-stack bytes — the shardable part of the model
    (every other weight is replicated per node under the decentralized
    schedule)."""
    if not cfg.is_moe:
        return 0.0
    quant, block, kinds = _resolve_quant(cfg, quant, block)
    return cfg.num_layers * _expert_layer_bytes(cfg, quant, block, kinds)


def model_weight_bytes(cfg, *, quant: str | None = None,
                       block: int | None = None) -> float:
    """Total stored weight bytes of the constructed params pytree:
    embedding (+ lm_head unless tied) + final norm + all layers.  The
    quantity ``engine.memory_stats()['weight_bytes']`` reports, exact
    against ``quantize_params(model.init(...))``."""
    quant, block, kinds = _resolve_quant(cfg, quant, block)
    p = _itemsize(cfg)
    d = cfg.d_model
    total = cfg.vocab_padded * d * p               # embed (always fp)
    if not cfg.tie_embeddings:
        hq = quant if "lm_head" in kinds else "none"
        total += quant_matrix_bytes(d, cfg.vocab_padded, itemsize=p,
                                    quant=hq, block=block)
    total += (2 * d if cfg.norm == "layernorm" else d) * p   # final_norm
    return total + cfg.num_layers * weight_bytes_per_layer(
        cfg, quant=quant, block=block)


def per_node_weight_bytes(cfg, *, n_nodes: int = 1,
                          quant: str | None = None,
                          block: int | None = None) -> float:
    """Weight bytes resident on ONE of ``n_nodes`` expert-parallel nodes:
    the expert stack divides across nodes, everything else (attention,
    router, embeddings) is replicated — the decentralized schedule's
    placement (paper Fig. 7), which is what the Table-2 memory budget
    constrains."""
    ex = expert_weight_bytes(cfg, quant=quant, block=block)
    shared = model_weight_bytes(cfg, quant=quant, block=block) - ex
    return shared + ex / max(n_nodes, 1)


def fits_in_memory(cfg, *, n_nodes: int = 1, quant: str | None = None,
                   block: int | None = None,
                   budget: float = M2_ULTRA_MEM_BYTES,
                   kv_pool_bytes: float = 0.0) -> bool:
    """Does the model (at a quant level) plus a KV pool fit one node's
    unified-memory budget?  The weight-bytes term composed with the KV
    capacity term: weights are the dominant consumer and quantization the
    lever that decides hostability at all."""
    return per_node_weight_bytes(cfg, n_nodes=n_nodes, quant=quant,
                                 block=block) + kv_pool_bytes <= budget


def max_model_at_budget(cfg, *, n_nodes: int = 1,
                        budget: float = M2_ULTRA_MEM_BYTES,
                        kv_pool_bytes: float = 0.0,
                        block: int | None = None) -> dict:
    """Which quant levels let ``n_nodes`` budget-sized nodes host this
    model (leaving ``kv_pool_bytes`` for the cache)?  Returns per-level
    fits/bytes plus ``level`` — the least-lossy level that fits (None if
    even int4 does not): the answer to "what fits on N M2-Ultra nodes at
    which quant level"."""
    out = {"fits": {}, "per_node_bytes": {}, "level": None}
    for level in WEIGHT_QUANT_LEVELS:
        b = per_node_weight_bytes(cfg, n_nodes=n_nodes, quant=level,
                                  block=block)
        out["per_node_bytes"][level] = b
        out["fits"][level] = b + kv_pool_bytes <= budget
        if out["level"] is None and out["fits"][level]:
            out["level"] = level
    return out


def kv_bytes_per_token(cfg=None, *, n_layers: int = 0, num_kv_heads: int = 0,
                       head_dim: int = 0, precision: int = 2,
                       quantized: bool = False) -> float:
    """KV-cache bytes one token occupies across all layers (K and V).
    Pass a ModelConfig or the raw dims; ``quantized`` models the int8
    cache (1 byte/value + one fp32 scale per (token, head) for each of
    K and V)."""
    if cfg is not None:
        n_layers, num_kv_heads, head_dim = (cfg.num_layers, cfg.num_kv_heads,
                                            cfg.head_dim)
        quantized = getattr(cfg, "kv_cache_dtype", "") == "int8"
    per_value = 1 if quantized else precision
    per_tok = 2 * num_kv_heads * head_dim * per_value
    if quantized:
        per_tok += 2 * num_kv_heads * 4          # fp32 scales
    return float(n_layers * per_tok)


def paged_attention_read_bytes(cfg, *, lengths, page_size: int,
                               max_blocks: int) -> dict:
    """Per-decode-step attention K/V bytes READ, gather path vs paged
    kernel, for a batch whose rows hold ``lengths`` context tokens.

    The gather path (the reference's virtual-cache gather) materializes
    every row's full block-table reach — ``max_blocks * page_size`` slots
    per row regardless of how many hold tokens — while the kernel
    (kernels/paged_attn.py) walks only the pages a row's live length
    touches.  Both read whole pages: that rounding is the page
    granularity, not a kernel artifact.  Returns per-step byte totals and
    their ratio — the virtual-cache traffic the kernel removes."""
    bpt = kv_bytes_per_token(cfg)
    gather = len(list(lengths)) * max_blocks * page_size * bpt
    kernel = sum(-(-(int(n) + 1) // page_size) * page_size
                 for n in lengths) * bpt
    return {"gather_bytes": float(gather), "kernel_bytes": float(kernel),
            "ratio": float(gather / kernel) if kernel else float("inf")}


def max_concurrent_requests(pool_bytes: float, bytes_per_token: float,
                            mean_context: int, *, page_size: int = 0,
                            slot_len: int = 0) -> int:
    """Memory-capacity term: how many requests a KV pool of ``pool_bytes``
    holds at once.

    The contiguous layout (``page_size=0``) reserves ``slot_len``
    (max_cache) token slots per admitted request regardless of use — the
    contiguous engine.  The paged layout rounds each request's real context
    up to whole pages only, so short requests stop paying for long ones'
    headroom; with ``page_size=1`` this is the information-theoretic bound
    pool_tokens / mean_context.  ``mean_context`` is prompt + generated
    tokens actually resident (the Table-2 budget divides by THIS, not by
    max_cache, once the cache is paged)."""
    if pool_bytes <= 0 or bytes_per_token <= 0:
        return 0
    pool_tokens = pool_bytes / bytes_per_token
    if page_size <= 0:
        per_req = max(slot_len, mean_context)
    else:
        per_req = -(-mean_context // page_size) * page_size
    return int(pool_tokens // max(per_req, 1))


def serving_capacity(cfg, *, pool_bytes: float, max_cache: int,
                     mean_context: int, page_size: int) -> dict:
    """Contiguous-vs-paged concurrency at EQUAL pool bytes (the paged
    layout's acceptance comparison): returns both bounds plus their ratio — the
    concurrency the paged layout buys from the same unified-memory
    budget."""
    bpt = kv_bytes_per_token(cfg)
    contiguous = max_concurrent_requests(pool_bytes, bpt, mean_context,
                                         slot_len=max_cache)
    paged = max_concurrent_requests(pool_bytes, bpt, mean_context,
                                    page_size=page_size)
    return {"bytes_per_token": bpt, "contiguous": contiguous,
            "paged": paged,
            "gain": paged / contiguous if contiguous else float("inf")}


def node_serving_capacity(cfg, *, n_nodes: int, max_cache: int,
                          mean_context: int, page_size: int,
                          quant: str | None = None,
                          budget: float = M2_ULTRA_MEM_BYTES) -> dict:
    """The weight-bytes term composed with the KV-capacity term:
    on ``n_nodes`` budget-sized nodes, the quantized weight store takes
    its per-node share first and WHATEVER REMAINS is the KV pool —
    ``serving_capacity`` then converts that pool into concurrent-request
    bounds.  One call answers "what fits on N M2-Ultra nodes at which
    quant level, and how many requests does the leftover memory serve"."""
    wb = per_node_weight_bytes(cfg, n_nodes=n_nodes, quant=quant)
    pool = max(budget - wb, 0.0)
    out = serving_capacity(cfg, pool_bytes=pool, max_cache=max_cache,
                           mean_context=mean_context, page_size=page_size)
    out.update(weight_bytes_per_node=wb, kv_pool_bytes=pool,
               fits=wb <= budget,
               quant=quant if quant is not None
               else getattr(cfg, "weight_quant", "none"))
    return out


def prefix_hit_ttft(w: MoEWorkload, hw: HardwareProfile, n_nodes: int,
                    prompt_len: int, shared_len: int, chunk_len: int,
                    decode_rows: int = 0, page_size: int = 1,
                    num_experts: int = 16, top_k: int = 4) -> float:
    """Modelled TTFT of a prompt whose leading ``shared_len`` tokens hit
    the prefix cache (serving/paging.PrefixCache): only the page-aligned
    shared prefix is skipped (rounded DOWN to whole pages — partial tail
    sharing additionally recovers up to a page, but never the final
    prompt token, which is always recomputed to produce the first logit).
    ``shared_len=0`` reproduces ``chunked_prefill_ttft`` exactly."""
    shared = min((shared_len // max(page_size, 1)) * max(page_size, 1),
                 prompt_len - 1)
    remaining = max(prompt_len - shared, 1)
    return chunked_prefill_ttft(w, hw, n_nodes, remaining, chunk_len,
                                decode_rows, num_experts, top_k)


def cost_efficiency(throughput: float, n_nodes: int,
                    hw: HardwareProfile) -> float:
    """Table 5 metric: tokens/sec per USD of list-price hardware."""
    return throughput / (n_nodes * hw.price_per_node)


PAPER_TABLE5 = {
    # solution: (n_nodes, throughput tokens/s, price/node USD)
    "databricks-8xh100": (1, 112.5, 289_000.0),
    "ours-2xm2ultra": (2, 5.9, 6_599.0),
}


def paper_table5() -> dict[str, float]:
    return {k: tp / (n * price) for k, (n, tp, price) in PAPER_TABLE5.items()}


# ---------------------------------------------------------------------------
# per-kind collective-byte predictions (analysis rule R2)
# ---------------------------------------------------------------------------
# The paper's §5.2 measurement — expert communication time ≈ expert
# computation time, dominated by per-message latency — makes the BYTES each
# schedule moves a first-class invariant: a schedule regression (an extra
# gather, a fallback silently engaging) shows up as a collective-byte
# mismatch long before a wall-clock benchmark notices.  This predicts, per
# device and per forward pass, the bytes each HLO collective kind should
# move for one (batch, seq) block, mirroring the reference's expert-parallel
# schedule bodies exactly (including their decode fallbacks).  The JAX
# package's analysis (rule R2) compares these numbers against the compiled
# program's per-kind collective bytes; the port counts each rank's operand
# bytes in ``core/collectives`` and its mesh tests hold them to these.


def predicted_collective_bytes(cfg, *, batch: int, seq: int,
                               n_exp_shards: int = 1,
                               n_batch_shards: int = 1,
                               itemsize: int | None = None,
                               n_moe_layers: int | None = None,
                               include_tp: bool = True) -> dict:
    """Expected per-device collective bytes by HLO kind for one forward of
    a (batch, seq) token block under ``cfg.expert_parallel``.

    Bytes are the collective's *operand* bytes (what launch/hlo.analyze
    bills), per device, summed over MoE layers.  Returns {} when there is
    no expert axis — a single-device serving program must contain no
    collectives at all, which R2 enforces with a floor instead of a
    tolerance.  Besides the expert schedule, ``include_tp`` adds the
    serve-mode tensor-parallel terms launch/sharding.params_pspec induces
    on the same "model" axis (vocab-sharded embedding psum, head-sharded
    attention-output psum, flat-sharded GQA k/v gathers); tiny aux pmeans
    (scalars) stay below any sensible floor and are omitted.
    """
    if n_exp_shards <= 1 or not getattr(cfg, "is_moe", False):
        return {}
    from repro_torch.core import moe as moe_lib  # lazy: keeps torch out
    iz = itemsize if itemsize is not None else _itemsize(cfg)
    d = cfg.d_model
    k = cfg.experts_per_token
    e_pad = cfg.num_experts_padded
    L = n_moe_layers if n_moe_layers is not None else cfg.num_layers
    n = n_exp_shards
    # expert_parallel.moe_layer drops the batch axes when they don't divide
    bs = n_batch_shards if n_batch_shards >= 1 and batch % max(n_batch_shards, 1) == 0 else 1
    t = batch * seq
    t_bs = max(t // bs, 1)              # tokens per batch shard

    def decentralized():
        # one psum of the (t_loc, d) expert output per layer
        return {"all-reduce": float(L * t_bs * d * iz)}

    def centralized():
        if seq % n != 0:
            # decode fallback: psum + value-preserving ring permute
            nb = float(L * t_bs * d * iz)
            return {"all-reduce": nb, "collective-permute": nb}
        t_loc = t_bs // n
        # comm 1 gathers the activation block AND its bool token mask
        return {"all-gather": float(L * t_loc * (d * iz + 1)),
                "reduce-scatter": float(L * t_bs * d * iz)}

    def a2a(m: int = 1):
        if seq % n != 0:
            return decentralized()      # single-token decode fallback
        t_loc = t_bs // n
        if m > 1 and (t_loc % m != 0 or t_loc // m < 1):
            m = 1                       # a2a_pipelined -> plain a2a
        cap = moe_lib.round_capacity(max(t_loc // m, 1), k, e_pad,
                                     cfg.capacity_factor)
        e_local = e_pad // n
        # dispatch + combine all_to_all of (n, e_local*cap, d) per chunk
        return {"all-to-all": float(2 * L * m * n * e_local * cap * d * iz)}

    sched = getattr(cfg, "expert_parallel", "decentralized")
    if sched == "centralized":
        out = centralized()
    elif sched == "a2a":
        out = a2a()
    elif sched == "a2a_pipelined":
        out = a2a(max(getattr(cfg, "ep_microchunks", 1), 1))
    else:
        out = decentralized()

    if include_tp:
        def add(kind, nb):
            out[kind] = out.get(kind, 0.0) + float(nb)
        La = cfg.num_layers          # attention sits in every layer
        # vocab-sharded embedding table -> one psum of the (t_loc, d)
        # input activations per forward
        add("all-reduce", t_bs * d * iz)
        # head-sharded attention: per-layer psum of wo's partial outputs
        if cfg.num_heads % n == 0:
            add("all-reduce", La * t_bs * d * iz)
        # GQA k/v sharded on the flat head*dim axis: each device gathers
        # the new tokens' k and v before the (replicated) cache update
        kv_flat = cfg.num_kv_heads * cfg.head_dim
        if cfg.num_kv_heads % n != 0 and kv_flat % n == 0:
            add("all-gather", 2 * La * t_bs * (kv_flat // n) * iz)
    return out
