"""JAX oracle of ``tests/test_torch_families_mesh.py``: for one of the four
families (recurrentgemma-2b, mamba2-130m, qwen2-vl-7b, musicgen-large,
reduced), the reference's forward, ``value_and_grad`` of its loss and one
jitted train step on a (2, 2) host mesh, and its serve on one device
(vlm and audio: prefill and seeded decode steps; hybrid and ssm: the
two-program engine's greedy streams), written to an npz.

    python tests/torch_families_mesh_oracle.py PARAMS_NPZ OUT_NPZ ARCH

The test runs one process per arch at once.  Run in a fresh process: the
host device count is set before JAX loads.  The mesh is built with
``Auto`` axes and the calls run under ``jax.set_mesh`` (the reference's
``launch/mesh.make_test_mesh`` builds ``Explicit`` axes under jax 0.9,
whose ``shard_map`` refuses a jit outside a mesh context); the params are
not placed: GSPMD gives the same values in any layout.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_families_mesh_cases as cases  # noqa: E402
from repro import optim  # noqa: E402
from repro.configs.base import get_config  # noqa: E402
from repro.launch.train import make_train_step  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.serving.engine import EngineConfig, ServingEngine  # noqa: E402


def main(params_path: str, out_path: str, arch: str) -> None:
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = jax.tree.map(jnp.asarray, cases.unflatten(np.load(params_path),
                                                       arch + "/"))
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    gb = {k: jnp.asarray(v) for k, v in cases.batch(arch, cfg).items()}
    out = {}
    with jax.set_mesh(mesh):
        logits, _ = jax.jit(lambda p, b: model.forward(p, b, mesh))(params,
                                                                    gb)
        out["forward"] = np.asarray(logits)
        (total, m), g = jax.jit(lambda p, b: jax.value_and_grad(
            model.loss, has_aux=True)(p, b, mesh))(params, gb)
        out["grad/loss"] = np.asarray(total)
        out["grad/ce"] = np.asarray(m["ce"])
        out.update(cases.flatten(jax.tree.map(np.asarray, g), "grad/grads/"))
        step = jax.jit(make_train_step(
            model, optim.OptimizerConfig(**cases.STEP_OPT), mesh))
        p1, _, m = step(params, optim.init(params), gb)
        for k in ("loss", "ce", "grad_norm", "lr"):
            out[f"step/{k}"] = np.asarray(m[k])
        out.update(cases.flatten(jax.tree.map(np.asarray, p1),
                                 "step/params/"))
    if arch in cases.STATEFUL:
        eng = ServingEngine(cfg, EngineConfig(
            async_steps=False, track_experts=False, **cases.ENGINE),
            params=params)
        uids = [eng.submit(p, max_new_tokens=n)
                for p, n in cases.traffic(cfg)]
        eng.run_until_done()
        for i, u in enumerate(uids):
            out[f"serve/{i}"] = np.asarray(eng._all[u].generated, np.int64)
    else:
        prefill = jax.jit(model.prefill)
        decode = jax.jit(model.decode_step)
        b = {k: jnp.asarray(v) for k, v in cases.inputs(
            arch, cfg, cases.SERVE_B, 3).items()}
        lg, cache = prefill(params, b, model.init_cache(cases.SERVE_B,
                                                        cases.SERVE_CACHE))
        steps = [np.asarray(lg)]
        for st in cases.decode_steps(arch, cfg):
            lg, cache = decode(params, cache, {k: jnp.asarray(v)
                                               for k, v in st.items()})
            steps.append(np.asarray(lg))
        out["serve"] = np.stack(steps)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:4])
