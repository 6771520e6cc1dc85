"""The port's training path against the JAX reference's, on JAX-initialised
weights bridged into the port and the same numpy batches.

``Model.loss(..., kernels=False)`` differentiated by autograd is held to
``jax.value_and_grad(model.loss)`` of the reference config as
``get_config`` gives it (``use_kernel`` and ``use_flash_kernel`` off: the
reference trains through no Pallas kernel), for the five reduced archs
(granite and DBRX with router-dead experts and a padded vocab), with
``remat`` on and off on both sides.  Then three steps of
``make_train_step`` against the reference's jitted step, ``attend_chunked``
and its gradients at small chunks, and the launcher.

Tolerances (fp32): the loss to 2e-5 relative; each gradient leaf to
2e-4 of its own largest magnitude (sums over tokens run in another order,
and the tied embedding's gradient adds the lookup's and the head's);
router-dead experts' gradients exactly zero on both sides.  After three
AdamW steps (lr 1e-3) the losses, norms and rates agree to 1e-4, at least
99.9% of each param leaf's elements to 1e-6, and every element to lr:
Adam moves a weight by lr x m/sqrt(v), and its first step by lr x
sign(g), so where a gradient sits within rounding of zero the two sides
may differ by up to a step (here a few hundredths of lr)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.ckpt import io as jckpt
from repro.launch.train import make_train_step as jax_make_train_step
from repro.models import attention as jattention
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge, optim
from repro_torch.ckpt import io as ckpt
from repro_torch.data.pipeline import Pipeline, PipelineConfig
from repro_torch.kernels import flash_attn, moe_gemm, ops
from repro_torch.launch import train as train_mod
from repro_torch.models import attention
from repro_torch.models.model import build_model
from torch_archs import ARCHS, DENSE_ARCHS, NEW_ARCHS, reduced_pair

ALL_ARCHS = ARCHS + DENSE_ARCHS
LOSS_RTOL = 2e-5
GRAD_TOL = 2e-4


def _setup(arch, **kw):
    jcfg, cfg = reduced_pair(arch, **kw)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = bridge.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
    return jmodel, jparams, build_model(cfg, "cpu"), params


def _batch(vocab, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_value_and_grad(model, params, batch):
    leaves = list(optim.adamw.tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    total, m = model.loss(params, _torch(batch), kernels=False)
    total.backward()
    grads = optim.adamw.tree_map(lambda p: p.grad, params)
    return float(total.detach()), float(m["ce"].detach()), float(
        m["aux"].detach()), grads


def _check_grads(cfg, grads, jgrads):
    """Each port gradient leaf against the JAX one, carried over by the
    weight bridge (a gradient tree has the params' structure)."""
    want = ckpt.flatten_tree(bridge.from_jax_params(
        jax.tree.map(np.asarray, jgrads), cfg, "cpu"))
    got = ckpt.flatten_tree(grads)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.numpy()
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, k
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * scale, f"{k}: {err} vs scale {scale}"


def _dead_expert_grads(cfg, grads) -> list:
    """The router-dead experts' gradient slices (experts >= num_experts)."""
    return [np.asarray(grads["blocks"]["experts"][w])[:, cfg.num_experts:]
            for w in ("w_gate", "w_up", "w_down")]


GRAD_CASES = [(a, r) for a in ALL_ARCHS for r in (False, True)]


@pytest.mark.parametrize("arch,remat", GRAD_CASES, ids=[
    f"{a}-{'remat' if r else 'no_remat'}" for a, r in GRAD_CASES])
def test_loss_and_grads_match_reference(arch, remat):
    jmodel, jparams, model, params = _setup(arch, remat=remat)
    cfg = model.cfg
    batch = _batch(cfg.vocab_size, 2, 64)
    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(jmodel.loss,
                                                     has_aux=True))(
        jparams, _jax(batch))
    ops.reset_launch_counts()
    total, ce, aux, grads = _port_value_and_grad(model, params, batch)
    assert not any(ops.launch_counts().values())
    for got, want in ((total, jtotal), (ce, jm["ce"]), (aux, jm["aux"])):
        assert abs(got - float(want)) <= LOSS_RTOL * (1 + abs(float(want)))
    _check_grads(model.cfg, grads, jgrads)
    if cfg.num_experts_padded > cfg.num_experts:
        for g in _dead_expert_grads(cfg, grads) \
                + _dead_expert_grads(cfg, jgrads):
            assert g.size and not g.any()


def test_long_sequence_grads_match_reference():
    """B=1, S=2048: attention takes ``attend_chunked`` (CHUNK_THRESHOLD)
    and the loss the chunked CE (four checkpointed 512-token chunks)."""
    jmodel, jparams, model, params = _setup(ARCHS[0], remat=True)
    batch = _batch(model.cfg.vocab_size, 1, 2048, seed=1)
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss,
                                                    has_aux=True))(
        jparams, _jax(batch))
    total, _, _, grads = _port_value_and_grad(model, params, batch)
    assert abs(total - float(jtotal)) <= LOSS_RTOL * (1 + abs(float(jtotal)))
    _check_grads(model.cfg, grads, jgrads)


@pytest.mark.parametrize("window", [None, 40])
def test_attend_chunked_grads_match_reference(window):
    """Ragged chunks (S=100 over q/k chunks of 32 and 24) and GQA-repeated
    K/V: values to 2e-5, gradients of q, k and v to 2e-5 of their
    largest magnitude."""
    rng = np.random.default_rng(3)
    b, s, h, hd = 2, 100, 4, 16
    q, k, v, w = (rng.normal(size=(b, s, h, hd)).astype(np.float32)
                  for _ in range(4))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    scale = hd ** -0.5

    def jloss(q, k, v):
        out = jattention.attend_chunked(q, k, v, jnp.asarray(pos),
                                        jnp.asarray(pos), window, scale,
                                        q_chunk=32, k_chunk=24)
        return jnp.sum(out * w), out
    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (q, k, v))
    out = attention.attend_chunked(tq, tk, tv, torch.from_numpy(pos.copy()),
                                   torch.from_numpy(pos.copy()), window,
                                   scale, q_chunk=32, k_chunk=24)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    for t, g in zip((tq, tk, tv), jg):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 2e-5 * np.abs(g).max()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_three_train_steps_match_reference(arch):
    jmodel, jparams, model, params = _setup(arch)
    cfg = model.cfg
    kw = dict(lr=1e-3, total_steps=3, warmup_steps=1)
    jstep = jax.jit(jax_make_train_step(jmodel, joptim.OptimizerConfig(**kw),
                                        None))
    step = train_mod.make_train_step(model, optim.OptimizerConfig(**kw))
    jstate, state = joptim.init(jparams), optim.init(params)
    pc = dict(seq_len=32, global_batch=2, vocab_size=cfg.vocab_size, seed=4)
    jpipe, pipe = Pipeline(PipelineConfig(**pc)), Pipeline(PipelineConfig(**pc))
    ops.reset_launch_counts()
    for _ in range(3):
        jparams, jstate, jm = jstep(jparams, jstate, _jax(jpipe.next_batch()))
        params, state, m = step(params, state, _torch(pipe.next_batch()))
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            want = float(jm[key])
            assert abs(float(m[key]) - want) <= 1e-4 * (1 + abs(want)), key
    assert not any(ops.launch_counts().values())
    assert int(state.step) == 3
    got, want = ckpt.flatten_tree(params), jckpt.flatten_tree(jparams)
    for k in want:
        assert not got[k].requires_grad and got[k].grad is None
        err = np.abs(got[k].numpy() - np.asarray(want[k]))
        assert err.max() <= kw["lr"], (k, err.max())
        assert np.mean(err <= 1e-6) >= 0.999, (k, np.mean(err <= 1e-6))
    if arch in NEW_ARCHS:
        # a dead expert's slice moved by decay alone, as in the reference
        for w in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                np.asarray(state.mu["blocks"]["experts"][w])[
                    :, cfg.num_experts:], 0)


def test_training_path_reaches_no_kernel_module(monkeypatch):
    """With ``kernels=False`` neither a kernel wrapper nor a kernel's plain
    version is called: each raises if it is."""
    def refuse(*a, **k):
        raise AssertionError("the training path reached kernels/")
    for mod, name in ((ops, "flash_attention"), (ops, "moe_ffn"),
                      (moe_gemm, "moe_ffn_plain"),
                      (flash_attn, "flash_attention_plain")):
        monkeypatch.setattr(mod, name, refuse)
    for arch in (ARCHS[0], DENSE_ARCHS[0]):
        _, _, model, params = _setup(arch, remat=True)
        batch = _batch(model.cfg.vocab_size, 2, 16)
        _port_value_and_grad(model, params, batch)
        with pytest.raises(AssertionError, match="reached kernels"):
            model.loss(params, _torch(batch))


def test_kernel_path_still_refuses_grad():
    """The scoring loss keeps the kernels; on weights that require grad
    their wrappers raise, and the message names the trainer's path."""
    _, _, model, params = _setup(ARCHS[0])
    params["blocks"]["attn"]["wq"].requires_grad_(True)
    batch = _torch(_batch(model.cfg.vocab_size, 1, 8))
    with pytest.raises(NotImplementedError, match="kernels=False"):
        flash_attn.flash_attention(*(torch.zeros(1, 8, 2, 64,
                                                 requires_grad=True),) * 3)
    with pytest.raises(NotImplementedError, match="kernels=False"):
        moe_gemm.moe_ffn_kernel(torch.zeros(1, 1, 4, requires_grad=True),
                                *(torch.zeros(1, 4, 4),) * 3)
    # on the CPU the scoring path takes the plain versions, which autograd
    # differentiates as plain torch
    model.loss(params, batch)[0].backward()


def test_train_main_writes_a_checkpoint_jax_restores(tmp_path, capsys):
    path = str(tmp_path / "ck")
    train_mod.main(["--arch", "granite_moe_3b_a800m", "--reduced", "--device",
                    "cpu", "--steps", "3", "--batch", "2", "--seq", "32",
                    "--ckpt", path])
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and "saved checkpoint" in out
    restored, step = jckpt.restore(path)
    assert step == 3
    params, pstep = ckpt.restore(path, device="cpu")
    assert pstep == 3
    got, want = ckpt.flatten_tree(params), jckpt.flatten_tree(restored)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_train_history_and_refusals():
    cfg = reduced_pair(ARCHS[0])[1]
    params, history = train_mod.train(cfg, steps=4, global_batch=2,
                                      seq_len=16, log_every=2, device="cpu")
    assert [h["step"] for h in history] == [0, 2, 3]
    assert all(np.isfinite(h["loss"]) and h["lr"] > 0 for h in history)
    assert not params["embed"].requires_grad
    # a (1, 1) mesh (every collective an identity) trains as one device
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.Mesh(("data", "model"), {"data": 1, "model": 1},
                         {"data": 0, "model": 0},
                         {"data": None, "model": None})
    _, on_mesh = train_mod.train(cfg, steps=4, global_batch=2, seq_len=16,
                                 log_every=2, device="cpu", mesh=mesh)
    for a, b in zip(history, on_mesh):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * (1 + abs(a["loss"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_mod.train(cfg, steps=1, global_batch=1, seq_len=8)
