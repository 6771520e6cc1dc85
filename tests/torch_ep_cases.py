"""The cases of ``tests/test_torch_expert_parallel.py``, shared by its JAX
oracle (``torch_ep_oracle.py``, a subprocess with four host devices) and
its port side (gloo rank processes spawned by the test).  numpy only at
import: rank processes import this module and must not load JAX.

Every input is drawn here from a numpy seed, so both sides see the same
arrays; the forward cases read seeded parameters (``model_params``) from
an npz the test writes first."""
import numpy as np

SCHEDULES = ("decentralized", "centralized", "a2a", "a2a_pipelined")
STRATEGIES = ("dispatch", "dense")
BLOCKS = ((4, 16), (4, 1))                 # (B, S): prefill and decode
ODD_BLOCK = (3, 16)                        # B=3: the data axes do not divide
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}    # (n_data, n_model)
FORWARD_ARCHS = ("qwen3_moe_30b_a3b", "granite_moe_3b_a800m")
FORWARD_BLOCK = (4, 16)
# the moe_layer cases run on the reduced qwen3-moe (fp32) with a capacity
# that never binds; gather_decode_max_tk=0 keeps the dispatch path
MOE_FIELDS = dict(capacity_factor=8.0, ep_microchunks=2,
                  gather_decode_max_tk=0)


def moe_cases() -> dict:
    """name -> config fields of the moe_layer parity cases (both meshes):
    every schedule and strategy at each of ``BLOCKS``, the dispatch
    strategy at ``ODD_BLOCK``, and the capacity-free gather decode fast
    path (decentralized) at each block."""
    out = {}
    for b, s in BLOCKS + (ODD_BLOCK,):
        for ep in SCHEDULES:
            for strat in STRATEGIES:
                if (b, s) != ODD_BLOCK or strat == "dispatch":
                    out[f"{ep}-{strat}-{b}x{s}"] = dict(
                        MOE_FIELDS, expert_parallel=ep, moe_strategy=strat)
        out[f"gather-{b}x{s}"] = dict(MOE_FIELDS, expert_parallel=(
            "decentralized"), gather_decode_max_tk=4096)
    return out


def block_of(name: str) -> tuple:
    b, s = name.rsplit("-", 1)[1].split("x")
    return int(b), int(s)


def layer_params(d: int, f: int, e: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    mk = lambda scale, *shape: (rng.standard_normal(shape) * scale).astype(
        np.float32)
    return {"router": mk(0.1, d, e),
            "experts": {"w_gate": mk(0.05, e, d, f), "w_up": mk(0.05, e, d, f),
                        "w_down": mk(0.05, e, f, d)}}


def model_params(shapes: dict, seed: int = 0) -> dict:
    """Seeded fp32 parameters of a reduced model, from the port's
    ``bridge.param_shapes`` tree: N(0, 1/fan_in) matrices (embedding 0.02),
    unit norms (router-dead padded experts are drawn too, as the
    reference's init draws them)."""
    rng = np.random.default_rng(seed)

    def draw(path, shape):
        if path[-1] in ("ln1", "ln2", "final_norm", "q_norm", "k_norm",
                        "scale"):
            return np.ones(shape, np.float32)
        if path[-1] == "bias":
            return np.zeros(shape, np.float32)
        std = 0.02 if path[-1] == "embed" else 1 / np.sqrt(shape[-2])
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else draw(path + (k,), v) for k, v in tree.items()}
    return walk(shapes, ())


def moe_input(b: int, s: int, d: int) -> np.ndarray:
    return np.random.default_rng(100 * b + s).standard_normal(
        (b, s, d)).astype(np.float32)


def collective_input(rank: int) -> np.ndarray:
    """Rank ``rank``'s operand of the 16-bit sum cases: fp32 values that
    the ranks cast to bfloat16."""
    return np.random.default_rng(100 + rank).standard_normal(
        (8, 64)).astype(np.float32)


def forward_tokens(vocab: int) -> np.ndarray:
    b, s = FORWARD_BLOCK
    return np.random.default_rng(7).integers(0, vocab, (b, s)).astype(
        np.int32)


def flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dict of arrays as flat 'a/b/c' keys (an npz's layout)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat) -> dict:
    out = {}
    for key in flat:
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(flat[key])
    return out


# ---------------------------------------------------------------------------
# the port's side: one rank process of a mesh
# ---------------------------------------------------------------------------

QUANT_LEVELS = ("int8", "int4")
PIPELINE_M = (2, 4)
T_LOC_8 = (4, 8)        # T_loc = 8 on both meshes: m = 3 does not divide


def port_config(arch: str = "qwen3_moe_30b_a3b", **kw):
    from repro_torch.configs.base import get_config
    from torch_archs import DEAD_AND_PADDED, NEW_ARCHS
    extra = DEAD_AND_PADDED if arch in NEW_ARCHS else {}
    return get_config(arch).reduced().replace(**extra, **kw)


def padded_layer_params(d: int, f: int) -> tuple:
    """(6 live experts padded with 2 zero ones to 8, the 6 alone): the
    granite-style padding check."""
    lp = layer_params(d, f, 6, seed=7)
    pad = lambda a: np.concatenate([a, np.zeros((2,) + a.shape[1:],
                                                a.dtype)])
    return ({"router": np.pad(lp["router"], ((0, 0), (0, 2))),
             "experts": {k: pad(w) for k, w in lp["experts"].items()}}, lp)


def quantized_experts(experts: dict, level: str) -> dict:
    import torch
    from repro_torch.core import quant
    return {k: quant.quantize(torch.from_numpy(w), level)
            for k, w in experts.items()}


def _moe_run(torch, mesh, cfg, lp: dict, x: np.ndarray, experts=None):
    """One moe_layer call on this rank's blocks; ``experts`` (torch, whole)
    replaces ``lp``'s.  Returns the rank's record."""
    from repro_torch.core import expert_parallel as ep
    if experts is None:
        experts = {k: torch.from_numpy(w) for k, w in lp["experts"].items()}
    if max(cfg.expert_replication, 1) > 1:
        experts = {k: torch.cat([w] * cfg.expert_replication)
                   for k, w in experts.items()}
    layer_p = {"router": torch.from_numpy(lp["router"]),
               "experts": ep.expert_shard(cfg, experts, mesh)}
    axes, rows = ep.batch_shard(mesh, x.shape[0])
    mesh.reset_counters()
    y, aux, ti = ep.moe_layer(cfg, layer_p, torch.from_numpy(x[rows]),
                              mesh=mesh, batch_axes=axes)
    return {"rows": (rows.start, rows.stop), "y": y.numpy(),
            "aux": float(aux), "top_idx": ti.numpy(),
            "bytes": dict(mesh.bytes)}


def rank_main(rank: int, world: int, store: str, shape: tuple,
              params_path: str, q) -> None:
    """Every port case of one mesh on this rank; puts (rank, results) or
    (rank, traceback text) on ``q``."""
    import traceback
    try:
        q.put((rank, _rank_cases(rank, world, store, shape, params_path)))
    except BaseException:
        q.put((rank, traceback.format_exc()))
        raise


def _rank_cases(rank, world, store, shape, params_path) -> dict:
    import datetime

    import torch
    from repro_torch import bridge
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.model import build_model
    torch.set_num_threads(1)
    mesh_lib.init_ranks(rank, world, store,
                        timeout=datetime.timedelta(seconds=90))
    mesh = mesh_lib.make_test_mesh(*shape)
    out = {}
    from repro_torch.core import collectives
    x = torch.from_numpy(collective_input(rank)).to(torch.bfloat16)
    mesh.reset_counters()
    total = collectives.psum(x, mesh, "model")
    block = collectives.psum_scatter(x, mesh, "model", dim=0)
    out["sum16"] = {"dtypes": (str(total.dtype), str(block.dtype)),
                    "psum": total.float().numpy(),
                    "psum_scatter": block.float().numpy(),
                    "bytes": dict(mesh.bytes)}
    base = port_config()
    lp = layer_params(base.d_model, base.d_ff, base.num_experts_padded)
    for name, fields in moe_cases().items():
        out[f"moe/{name}"] = _moe_run(torch, mesh, base.replace(**fields),
                                      lp, moe_input(*block_of(name),
                                                    base.d_model))
    x16 = moe_input(*BLOCKS[0], base.d_model)
    for m in PIPELINE_M:
        out[f"pipelined/m{m}"] = _moe_run(torch, mesh, base.replace(**dict(
            MOE_FIELDS, expert_parallel="a2a_pipelined", ep_microchunks=m)),
            lp, x16)
    x8 = moe_input(*T_LOC_8, base.d_model)
    for ep, m in (("a2a", 1), ("a2a_pipelined", 3)):
        out[f"tloc8/{ep}"] = _moe_run(torch, mesh, base.replace(**dict(
            MOE_FIELDS, expert_parallel=ep, ep_microchunks=m)), lp, x8)
    gran = port_config("granite_moe_3b_a800m", experts_per_token=2,
                       **MOE_FIELDS)
    padded, _ = padded_layer_params(gran.d_model, gran.d_ff)
    x_pad = moe_input(4, 8, gran.d_model)
    for ep in SCHEDULES:
        out[f"padded/{ep}"] = _moe_run(torch, mesh, gran.replace(
            expert_parallel=ep), padded, x_pad)
    for r in (1, 2):
        out[f"replication/r{r}"] = _moe_run(torch, mesh, base.replace(
            **MOE_FIELDS, expert_replication=r), lp, x16)
    for level in QUANT_LEVELS:
        qexp = quantized_experts(lp["experts"], level)
        for ep in SCHEDULES:
            for b, s in BLOCKS:
                out[f"quant/{level}/{ep}/{b}x{s}"] = _moe_run(
                    torch, mesh, base.replace(**MOE_FIELDS,
                                              expert_parallel=ep),
                    lp, moe_input(b, s, base.d_model), qexp)
    flat = np.load(params_path)
    for arch in FORWARD_ARCHS:
        tree = unflatten({k[len(arch) + 1:]: flat[k] for k in flat
                          if k.startswith(arch + "/")})
        for ep in SCHEDULES:
            cfg = port_config(arch, expert_parallel=ep, ep_microchunks=2)
            params = bridge.from_jax_params(tree, cfg, "cpu", mesh=mesh)
            tokens = torch.from_numpy(forward_tokens(cfg.vocab_size))
            mesh.reset_counters()
            with torch.no_grad():
                logits, aux, routing = build_model(
                    cfg, "cpu").forward_seq_routed(params, {"tokens": tokens},
                                                   mesh)
            from repro_torch.core import expert_parallel
            rows = expert_parallel.batch_shard(mesh, tokens.shape[0])[1]
            out[f"forward/{arch}/{ep}"] = {
                "rows": (rows.start, rows.stop), "logits": logits.numpy(),
                "aux": float(aux), "routing": routing.numpy(),
                "bytes": dict(mesh.bytes)}
    torch.distributed.destroy_process_group()
    return out
