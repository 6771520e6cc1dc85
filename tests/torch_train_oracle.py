"""JAX oracle of ``tests/test_torch_train_mesh.py``: the reference's loss,
its gradients and its jitted train step on a (2, 2) host mesh, written to
an npz.

    python tests/torch_train_oracle.py PARAMS_NPZ OUT_NPZ PART NPARTS

The work is split over NPARTS processes run at once: part 0 initialises
every parameter set of ``torch_train_cases.PARAMS`` (``model.init`` of
``PRNGKey(0)``), writes them to PARAMS_NPZ for the port's ranks, and runs
the train steps; part i >= 1 initialises the sets its share of
``GRAD_CASES`` needs (the same values: the init is deterministic) and
runs those.  Each part writes its own OUT_NPZ.

Run in a fresh process: the host device count is set before JAX loads.
The mesh is built with ``Auto`` axes and the calls run under
``jax.set_mesh`` (the reference's ``launch/mesh.make_test_mesh`` builds
``Explicit`` axes under jax 0.9, whose ``shard_map`` refuses a jit
outside a mesh context); no file of the JAX package is changed for that.
The params are not placed: GSPMD gives the same values in any layout.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_train_cases as cases  # noqa: E402
from repro import optim  # noqa: E402
from repro.configs.base import get_config  # noqa: E402
from repro.launch.train import make_train_step  # noqa: E402
from repro.models.model import build_model  # noqa: E402


def config(pkey: str, fields: dict):
    arch, kw = cases.config_fields(pkey, fields)
    return get_config(arch).reduced().replace(**kw)


def init_params(pkey: str) -> dict:
    return jax.jit(build_model(config(pkey, {})).init)(jax.random.PRNGKey(0))


def main(params_path: str, out_path: str, part: str, nparts: str) -> None:
    part, nparts = int(part), int(nparts)
    mesh = jax.make_mesh(cases.MESH, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    if part == 0:
        trees = {k: init_params(k) for k in cases.PARAMS}
        flat = {}
        for k, t in trees.items():
            flat.update(cases.flatten(jax.tree.map(np.asarray, t), k + "/"))
        np.savez(params_path + ".part.npz", **flat)
        os.replace(params_path + ".part.npz", params_path)
        grad_cases = {}
    else:
        names = list(cases.GRAD_CASES)[part - 1::nparts - 1]
        grad_cases = {n: cases.GRAD_CASES[n] for n in names}
        trees = {k: init_params(k) for k in {p for p, _ in
                                             grad_cases.values()}}
    with jax.set_mesh(mesh):
        for name, (pkey, fields) in grad_cases.items():
            model = build_model(config(pkey, fields))
            b = {k: jnp.asarray(v) for k, v in cases.grad_batch(
                name, model.cfg.vocab_size).items()}
            (total, m), g = jax.jit(lambda p, bb: jax.value_and_grad(
                model.loss, has_aux=True)(p, bb, mesh))(trees[pkey], b)
            key = f"grad/{name}"
            out[key + "/loss"] = np.asarray(total)
            out[key + "/ce"] = np.asarray(m["ce"])
            out[key + "/aux"] = np.asarray(m["aux"])
            out[key + "/grad_norm"] = np.asarray(optim.global_norm(g))
            out.update(cases.flatten(jax.tree.map(np.asarray, g),
                                     key + "/grads/"))
        if part == 0:
            # every input and output replicated: one compile for both steps
            rep = NamedSharding(mesh, P())
            model = build_model(config(cases.STEP_PARAMS, cases.STEP_FIELDS))
            step = jax.jit(make_train_step(
                model, optim.OptimizerConfig(**cases.STEP_OPT), mesh),
                out_shardings=rep)
            params = jax.device_put(trees[cases.STEP_PARAMS], rep)
            state = jax.device_put(optim.init(params), rep)
            for i, b in enumerate(cases.step_batches(model.cfg.vocab_size)):
                params, state, m = step(params, state, jax.device_put(
                    {k: jnp.asarray(v) for k, v in b.items()}, rep))
                for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                    out[f"steps/{i}/{k}"] = np.asarray(m[k])
            out.update(cases.flatten(jax.tree.map(np.asarray, params),
                                     "steps/params/"))
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:5])
