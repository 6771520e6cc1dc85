"""JAX oracle of ``tests/test_torch_expert_parallel.py``: the reference's
expert-parallel ``moe_layer`` and mesh ``Model.forward`` on a four-device
host mesh, written to an npz.

    python tests/torch_ep_oracle.py PARAMS_NPZ OUT_NPZ MESH

MESH is a key of ``torch_ep_cases.MESHES`` ("2x2" or "1x4").

Run in a fresh process: the host device count is set before JAX loads.
The mesh is built with ``Auto`` axes and the calls run under
``jax.set_mesh``: the reference's ``launch/mesh.make_test_mesh`` builds
``Explicit`` axes by default under jax 0.9, whose ``shard_map`` then
refuses a jit outside a mesh context.  No file of the JAX package is
changed for that.  The JAX configs keep ``use_kernel`` and
``use_flash_kernel`` off (the reference's jnp paths).
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
import torch_ep_cases as cases  # noqa: E402
from repro.configs.base import get_config  # noqa: E402
from repro.core import expert_parallel  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from torch_archs import DEAD_AND_PADDED, NEW_ARCHS  # noqa: E402


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def forward_config(arch: str, ep: str):
    extra = DEAD_AND_PADDED if arch in NEW_ARCHS else {}
    return get_config(arch).reduced().replace(**extra, expert_parallel=ep,
                                              ep_microchunks=2)


def main(params_path: str, out_path: str, mname: str) -> None:
    """One jit per block over every moe_layer case of that block, and one
    over every forward case: a compile each, not one per case."""
    out = {}
    base = get_config("qwen3_moe_30b_a3b").reduced()
    layer_p = jax.tree.map(jnp.asarray, cases.layer_params(
        base.d_model, base.d_ff, base.num_experts_padded))
    flat = np.load(params_path)
    params = {arch: jax.tree.map(jnp.asarray, cases.unflatten(
        {k[len(arch) + 1:]: flat[k] for k in flat if k.startswith(arch + "/")}))
        for arch in cases.FORWARD_ARCHS}
    blocks = {}
    for name, fields in cases.moe_cases().items():
        blocks.setdefault(cases.block_of(name), {})[name] = fields
    mesh = mesh_of(cases.MESHES[mname])
    with jax.set_mesh(mesh):
        for (b, s), named in blocks.items():
            x = jnp.asarray(cases.moe_input(b, s, base.d_model))
            res = jax.jit(lambda lp, xx: {
                name: expert_parallel.moe_layer(base.replace(**f), mesh,
                                                lp, xx)
                for name, f in named.items()})(layer_p, x)
            for name, (y, aux, ti) in res.items():
                key = f"moe/{name}"
                out[key + "/y"] = np.asarray(y)
                out[key + "/aux"] = np.asarray(aux)
                out[key + "/top_idx"] = np.asarray(ti)
        models = {(arch, ep): build_model(forward_config(arch, ep))
                  for arch in cases.FORWARD_ARCHS
                  for ep in cases.SCHEDULES}
        toks = {arch: jnp.asarray(cases.forward_tokens(
            forward_config(arch, "a2a").vocab_size))
            for arch in cases.FORWARD_ARCHS}
        res = jax.jit(lambda p, t: {
            key: m.forward(p[key[0]], {"tokens": t[key[0]]}, mesh)
            for key, m in models.items()})(params, toks)
        for (arch, ep), (logits, aux) in res.items():
            key = f"forward/{arch}/{ep}"
            out[key + "/logits"] = np.asarray(logits)
            out[key + "/aux"] = np.asarray(aux)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:4])
