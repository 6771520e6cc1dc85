"""Port vs JAX for the full-sequence forward and the forward loss of the
reduced ``qwen3_moe_30b_a3b`` (and of granite and DBRX with router-dead
experts and padded vocab, ``torch_archs``), on JAX-initialised weights bridged into the
port (``bridge.from_jax_params``: the forward reads the same tree as the
serving step) and the same numpy tokens.

The JAX model runs with ``use_kernel=True`` (its grouped-FFN Pallas kernel
in interpret mode) and with ``use_flash_kernel`` on (the Pallas flash
kernel, interpret mode) or off (its dense ``attend``); the port has one
path, ``attn_forward`` through ``ops.flash_attention``, which takes its
plain version on the CPU.  The MoE layer runs at the config's own
capacity factor over T = B*S tokens (``dispatch_moe``).  In fp32 logits
and losses agree to 2e-4, as the JAX suite holds its flash forward to its
plain one.

bf16 is compared against a JAX run in a fresh process with XLA's excess
precision off: by default XLA on the CPU keeps fp32 values inside fused
bf16 chains where the source rounds to bf16, so the reference is then
closer to an fp32 run than to its own source (on these inputs one token's
routing flips between the two, moving its logits by 0.9).  With the
source's rounding points the port agrees with the dense ``attend`` path
to 3e-2; the Pallas flash kernel rounds p against each key tile's running
max instead of the row's, and it differs from ``attend`` by up to about
5e-2 here, so the port is held to it at 6e-2."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.models import model as model_mod
from repro_torch.models.model import build_model
from torch_archs import ARCHS, reduced_pair

ARCH = ARCHS[0]
BF16 = {"dtype": "bfloat16", "param_dtype": "bfloat16"}
SOURCE_ROUNDING = "--xla_allow_excess_precision=false"
WINDOW = {"long_context_threshold": 32, "long_context_window": 16}
# name -> (config fields for both sides, JAX use_flash_kernel, B, S, tol)
CASES = {
    "fp32_flash": ({}, True, 2, 64, 2e-4),
    "fp32_attend": ({}, False, 2, 64, 2e-4),
    "int8_weights_flash": ({"weight_quant": "int8"}, True, 2, 64, 2e-4),
    "window_flash": (WINDOW, True, 2, 64, 2e-4),
    "window_attend": (WINDOW, False, 2, 64, 2e-4),
    "chunked_ce_flash": ({}, True, 1, 1024, 2e-4),
    "granite_flash": ({}, True, 2, 64, 2e-4),
    "dbrx_flash": ({}, True, 2, 64, 2e-4),
}
# the cases of the other archs: router-dead experts, padded vocab, a tied
# head (granite) and layernorm (DBRX)
CASE_ARCH = {"granite_flash": "granite_moe_3b_a800m", "dbrx_flash": "dbrx"}


def _setup(name):
    fields, flash, b, s, tol = CASES[name]
    jcfg, cfg = reduced_pair(CASE_ARCH.get(name, ARCH), dict(
        use_kernel=True, use_flash_kernel=flash), **fields)
    jmodel = jax_build_model(jcfg)
    jparams = jq.quantize_params(jmodel.init(jax.random.PRNGKey(0)), jcfg)
    params = bridge.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
    rng = np.random.default_rng(s)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return (jmodel, jparams, build_model(cfg, "cpu"), params,
            {"tokens": tokens, "labels": labels}, tol)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    jmodel, jparams, model, params, batch, tol = _setup(name)
    jlogits, jaux = jmodel.forward(jparams, _jax({"tokens": batch["tokens"]}))
    ops.reset_launch_counts()
    logits, aux = model.forward(params, _torch({"tokens": batch["tokens"]}))
    assert not any(ops.launch_counts().values())
    assert logits.dtype == torch.float32
    assert logits.shape == (*batch["tokens"].shape, model.cfg.vocab_padded)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name, monkeypatch):
    jmodel, jparams, model, params, batch, tol = _setup(name)
    jtotal, jm = jmodel.loss(jparams, _jax(batch))
    rows = []
    head = model_mod._lm_head
    monkeypatch.setattr(model_mod, "_lm_head", lambda cfg, p, x: (
        rows.append(x.shape[1]), head(cfg, p, x))[1])
    total, m = model.loss(params, _torch(batch))
    for got, want in ((total, jtotal), (m["ce"], jm["ce"]),
                      (m["aux"], jm["aux"])):
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=tol,
                                   atol=tol)
    s = batch["tokens"].shape[1]
    # S=1024 takes the chunked branch: the head sees two 512-token chunks
    assert rows == ([512, 512] if s == 1024 else [s])


def test_window_reaches_the_attention():
    """With ``long_context_threshold=32`` a 64-token sequence attends
    through a 16-token window (``effective_window``): its logits differ
    from the full-causal forward on the same weights past the first 16
    positions.  (Row 0's first 16 tokens also lead the MoE dispatch order,
    so no later token can take their expert capacity.)"""
    _, _, model, params, batch, _ = _setup("window_flash")
    full = build_model(model.cfg.replace(long_context_window=0), "cpu")
    tokens = _torch({"tokens": batch["tokens"]})
    windowed, _ = model.forward(params, tokens)
    causal, _ = full.forward(params, tokens)
    np.testing.assert_allclose(windowed[0, :16].numpy(),
                               causal[0, :16].numpy(), rtol=1e-5, atol=1e-5)
    assert float((windowed[0, 16:] - causal[0, 16:]).abs().max()) > 1e-3


def test_cpu_forward_differentiates_through_plain_versions():
    """Autograd through the plain versions is plain PyTorch (as jax.grad
    through the reference's plain paths is), so the CPU forward runs with
    weights that require grad; only the kernel wrappers refuse them."""
    _, _, model, params, batch, _ = _setup("fp32_flash")
    params["blocks"]["attn"]["wq"].requires_grad_(True)
    logits, _ = model.forward(params, _torch({"tokens": batch["tokens"]}))
    assert logits.grad_fn is not None


def bf16_runs(path: str) -> None:
    """Run in a fresh process (see the module note): the JAX bf16 forward
    and loss with and without the flash kernel, and the port's, saved to
    ``path`` as fp32 numpy arrays."""
    out = {}
    for flash in (True, False):
        CASES["bf16"] = (BF16, flash, 2, 64, None)
        jmodel, jparams, model, params, batch, _ = _setup("bf16")
        tag = "flash" if flash else "attend"
        tokens = {"tokens": batch["tokens"]}
        logits, aux = jmodel.forward(jparams, _jax(tokens))
        total, m = jmodel.loss(jparams, _jax(batch))
        out.update({f"{tag}/logits": np.asarray(logits),
                    f"{tag}/aux": np.asarray(aux), f"{tag}/total":
                    np.asarray(total), f"{tag}/ce": np.asarray(m["ce"])})
    logits, aux = model.forward(params, _torch(tokens))
    total, m = model.loss(params, _torch(batch))
    out.update({"port/logits": logits.numpy(), "port/aux": aux.numpy(),
                "port/total": total.numpy(), "port/ce": m["ce"].numpy()})
    np.savez(path, **out)


@pytest.fixture(scope="module")
def bf16(tmp_path_factory):
    path = tmp_path_factory.mktemp("bf16") / "runs.npz"
    flags = f"{os.environ.get('XLA_FLAGS', '')} {SOURCE_ROUNDING}".strip()
    here = Path(__file__).resolve().parent
    subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(here)!r})"
         f"; import test_torch_forward as t; t.bf16_runs({str(path)!r})"],
        env=dict(os.environ, XLA_FLAGS=flags), cwd=here.parent, check=True,
        timeout=600)
    return dict(np.load(path))


@pytest.mark.parametrize("ref,tol", [("attend", 3e-2), ("flash", 6e-2)])
def test_bf16_forward_and_loss_match_jax(bf16, ref, tol):
    assert bf16["port/logits"].dtype == np.float32
    for key in ("logits", "aux", "total", "ce"):
        np.testing.assert_allclose(bf16[f"port/{key}"], bf16[f"{ref}/{key}"],
                                   rtol=tol, atol=tol, err_msg=key)
