"""JAX oracle of ``tests/test_torch_serve_mesh.py``: the reference's
one-device ``ServingEngine`` streams on the shared weights, its mesh
engine's and one-device engine's streams on traffic where the MoE
capacity binds, and its ``attention.attn_decode_step_cp`` on a (2, 2)
host mesh, written to an npz.

    python tests/torch_serve_oracle.py PARAMS_NPZ OUT_NPZ [PART]

PART "binding" runs the capacity-binding engines alone, any other value
(the default) the rest; the test runs both parts at once.

Run in a fresh process: the host device count is set before JAX loads.
The mesh is built with ``Auto`` axes and the decode runs under
``jax.set_mesh`` (``torch_ep_oracle.py`` says why).  The JAX engine keeps
``use_kernel`` and ``paged_kernel`` off (the reference's jnp paths, which
the port's plain versions follow on the CPU).
"""
import itertools
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_serve_cases as cases  # noqa: E402
from repro.configs.base import get_config  # noqa: E402
from repro.models import attention  # noqa: E402
from repro.serving.engine import EngineConfig, ServingEngine  # noqa: E402


def config(arch: str, quant: str = "fp32", **kw):
    name, fields = cases.ARCHS[arch]
    return get_config(name).reduced().replace(
        **fields, **cases.CFG, **cases.QUANT[quant], **kw)


def binding(trees, mesh, out) -> None:
    """The one-device and the (2, 2) mesh engine's streams on the traffic
    where capacity binds."""
    for ep in cases.BINDING_SCHEDULES:
        cfg = get_config(cases.ARCHS["moe"][0]).reduced().replace(
            **cases.binding_fields(ep))
        for where, m in (("single", None), ("mesh", mesh)):
            eng = ServingEngine(cfg, EngineConfig(
                async_steps=False, paged_kernel=False,
                **cases.BINDING_ENGINE), params=trees["moe"], mesh=m)
            with jax.set_mesh(mesh):
                uids = [eng.submit(p, max_new_tokens=n)
                        for p, n in cases.binding_traffic()]
                eng.run_until_done()
            for i, u in enumerate(uids):
                out[f"binding/{ep}/{where}/{i}"] = np.asarray(
                    eng._all[u].generated, np.int64)


def main(params_path: str, out_path: str, part: str = "engines") -> None:
    flat = np.load(params_path)
    trees = {a: jax.tree.map(jnp.asarray, cases.unflatten(
        {k[len(a) + 1:]: flat[k] for k in flat if k.startswith(a + "/")}))
        for a in cases.ARCHS}
    out = {}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    if part == "binding":
        binding(trees, mesh, out)
        np.savez(out_path, **out)
        return
    for arch, quant, mode in cases.ORACLE_RUNS:
        eng = ServingEngine(config(arch, quant), EngineConfig(
            async_steps=False, paged_kernel=False, **cases.ENGINE,
            **cases.MODES[mode]), params=trees[arch])
        uids = [eng.submit(p, max_new_tokens=n) for p, n in cases.traffic()]
        eng.run_until_done()
        for i, u in enumerate(uids):
            out[f"serve/{cases.oracle_key(arch, quant, mode)}/{i}"] = \
                np.asarray(eng._all[u].generated, np.int64)
    for (name, window), (quant, kv) in itertools.product(
            cases.CP_WINDOWS.items(), cases.CP_CACHE.items()):
        cfg = config("dense", kv_cache_dtype=kv)
        p = cases.layer0(trees["dense"]["blocks"])["attn"]
        cache = attention.init_layer_cache(cfg, cases.CP_B, cases.CP_LEN,
                                           jnp.float32)
        step = jax.jit(lambda p_, c, x, ln: attention.attn_decode_step_cp(
            p_, cfg, c, x, ln, window, mesh))
        ys = []
        with jax.set_mesh(mesh):
            for x, lengths in cases.cp_inputs(cfg.d_model,
                                              window is not None):
                y, cache = step(p, cache, jnp.asarray(x), jnp.asarray(lengths))
                ys.append(np.asarray(y))
        out[f"{name}/{quant}/out"] = np.stack(ys)
        for k, v in cache.items():
            out[f"{name}/{quant}/cache/{k}"] = np.asarray(v)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:4])
