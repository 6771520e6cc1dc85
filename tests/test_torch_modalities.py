"""Port vs JAX: the vlm and audio families (Qwen2-VL-7B's backbone with
M-RoPE and patch embeddings, MusicGen-Large's decoder with frame
embeddings and sinusoidal positions), on JAX-initialised weights bridged
into the port and the same numpy inputs.

The reduced configs (2 layers, d 256): qwen2-vl's at hd 128 with two
query heads on two kv heads and 8 patch positions, M-RoPE sections (16,
24, 24); musicgen's GeGLU, layernorm and untied head.  Tolerances:
``apply_mrope`` 1e-6; ``sinusoidal_embedding`` 1e-6 at positions below
16, and beyond them 1e-6 plus the position times two ulps of a frequency
(XLA's and PyTorch's ``exp`` round a few frequencies apart, which the
angle multiplies by the position); forward
logits and loss fp32 2e-5; every gradient leaf of ``loss(kernels=False)``
within 2e-4 of its largest; ``prefill`` then four ``decode_step``s 2e-5
at each step; the audio ``train()`` losses 2e-5 for two steps.

The refusals fall where the reference fails: its engine (and its serve
launcher) gives these families the two-program path, whose prefill hands
the model the tokens alone, so the first step raises ``KeyError`` on
``patch_embeds`` or ``frame_embeds``, and its trainer's launcher feeds a
vlm model no patches.  The port raises a ``ValueError`` naming the key at
construction.  ``forward_routed`` refuses both on both sides.  On a mesh
the refusal is the port's alone: the reference lays these families out
as it lays out the dense one; ROADMAP queue A ports that next.  The
sinusoidal engine case (reduced qwen3-moe with ``positional=
"sinusoidal"``, streams equal to the JAX engine's) is
``tests/test_torch_engine.py::test_out_of_slice_options_raise``."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core import perf_model as jax_perf_model
from repro.launch import serve as jax_serve
from repro.launch import train as jax_train
from repro.models import layers as jax_layers
from repro.models.model import build_model as jax_build_model
from repro.models.model import sinusoidal_embedding as jax_sinusoidal
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import bridge, optim
from repro_torch.ckpt import io as ckpt
from repro_torch.configs.base import get_config
from repro_torch.core import perf_model
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import sharding
from repro_torch.launch import train as train_mod
from repro_torch.models import layers
from repro_torch.models import model as model_mod
from repro_torch.serving.engine import EngineConfig, ServingEngine
from torch_archs import (MODALITY_ARCHS, one_torch_thread,  # noqa: F401
                         reduced_pair)

TOL = 2e-5
ROPE_TOL = 1e-6
GRAD_TOL = 2e-4
VLM, AUDIO = MODALITY_ARCHS
B, TEXT, S_AUDIO, DECODE_STEPS = 2, 40, 48, 4
KEY = {VLM: "patch_embeds", AUDIO: "frame_embeds"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _mrope_positions(p: int, text: int) -> np.ndarray:
    """(p + text, 3): a p // 2 x 2 patch grid at t = 0 (distinct height
    and width components), then the text at max + 1 on all three."""
    i = np.arange(p)
    patches = np.stack([0 * i, i // 2, i % 2], -1)
    t = patches.max() + 1 + np.arange(text)
    return np.concatenate([patches, np.repeat(t[:, None], 3, 1)]).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _arch(arch: str):
    """The arch's config pair, JAX model, its weights (one jitted init),
    jitted forward and loss, and a seeded batch with labels."""
    jcfg, cfg = reduced_pair(arch)
    jmodel = jax_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    d, v = cfg.d_model, cfg.vocab_size
    if arch == VLM:
        p = cfg.num_patch_tokens
        s = p + TEXT
        batch = {"tokens": rng.integers(0, v, (B, TEXT)).astype(np.int32),
                 "patch_embeds": rng.standard_normal((B, p, d)).astype(
                     np.float32),
                 "mrope_positions": np.broadcast_to(
                     _mrope_positions(p, TEXT), (B, s, 3)).copy()}
    else:
        s = S_AUDIO
        batch = {"frame_embeds": rng.standard_normal((B, s, d)).astype(
            np.float32)}
    batch["labels"] = rng.integers(0, v, (B, s)).astype(np.int32)
    return types.SimpleNamespace(
        jcfg=jcfg, cfg=cfg, jmodel=jmodel, jparams=jparams, batch=batch,
        forward=jax.jit(jmodel.forward), loss=jax.jit(jmodel.loss))


def _params(a):
    """A fresh bridged copy of the arch's JAX weights."""
    return bridge.from_jax_params(jax.tree.map(np.asarray, a.jparams), a.cfg,
                                  "cpu")


def _batches(batch):
    """The same numpy batch for JAX and for the port."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


def test_apply_mrope_matches_reference():
    """Each frequency pair rotates by its section's component; swapping two
    sections, or two components of the positions, changes the result, so
    the inputs tell the three components apart."""
    rng = np.random.default_rng(0)
    pos = np.broadcast_to(_mrope_positions(8, 12), (2, 20, 3)).copy()
    x = rng.standard_normal((2, 20, 3, 128)).astype(np.float32)
    sections = (16, 24, 24)
    want = jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                  sections)
    got = layers.apply_mrope(_t(x), _t(pos), 1e6, sections)
    _close(got, want, ROPE_TOL)
    swapped = layers.apply_mrope(_t(x), _t(pos), 1e6, (24, 16, 24))
    assert not torch.allclose(swapped, got, atol=1e-3)
    hw = layers.apply_mrope(_t(x), _t(pos[..., [0, 2, 1]]), 1e6, sections)
    assert not torch.allclose(hw, got, atol=1e-3)
    # text positions (all three components equal) rotate as plain RoPE
    text = slice(8, 20)
    _close(got[:, text], jax_layers.apply_rope(
        jnp.asarray(x[:, text]), jnp.asarray(pos[:, text, 0]), 1e6),
        ROPE_TOL)


@pytest.mark.parametrize("d", [256, 2048])
def test_sinusoidal_embedding_matches_reference(d):
    """At positions 0..15 within 1e-6.  Up to 4096, every entry within
    1e-6 plus the position times 2^-23: the frequencies lie in (0, 1],
    where each library's fp32 ``exp`` is within an ulp (at most 2^-24) of
    the exact value, so the two tables differ by at most 2^-23, which the
    angle multiplies by the position (measured: 2.4e-4 at position 2100,
    d 2048)."""
    pos = np.arange(4096, dtype=np.int32).reshape(2, 2048)
    want = np.asarray(jax_sinusoidal(jnp.asarray(pos), d))
    got = model_mod.sinusoidal_embedding(_t(pos), d)
    assert got.dtype == torch.float32 and got.shape == (2, 2048, d)
    _close(got[0, :16], want[0, :16], ROPE_TOL)
    err = np.abs(got.numpy() - want)
    assert (err <= ROPE_TOL + pos[..., None] * 2.0 ** -23).all()


@pytest.mark.parametrize("case", ["vlm-mrope", "vlm-rope", "audio"])
def test_forward_and_loss_match_reference(case):
    """vlm with and without ``mrope_positions`` (without them its
    attention takes plain RoPE, as the reference's), its loss leaving the
    patch positions out; audio from frame embeddings with sinusoidal
    positions.  On the CPU the port's attention takes the flash kernel's
    plain version."""
    a = _arch(VLM if case.startswith("vlm") else AUDIO)
    batch = dict(a.batch)
    if case == "vlm-rope":
        batch.pop("mrope_positions")
    jb, tb = _batches(batch)
    model = model_mod.build_model(a.cfg, "cpu")
    params = _params(a)
    want, _ = a.forward(a.jparams, jb)
    jtotal, jm = a.loss(a.jparams, jb)
    ops.reset_launch_counts()
    with torch.no_grad():
        got, aux = model.forward(params, tb)
        total, m = model.loss(params, tb)
    assert not any(ops.launch_counts().values())
    _close(got, want)
    assert float(aux) == 0.0
    for g, w in ((total, jtotal), (m["ce"], jm["ce"])):
        assert abs(float(g) - float(w)) <= TOL * (1 + abs(float(w)))
    if case == "vlm-mrope":
        # the loss leaves the patch positions out: labels there change
        # nothing
        tb["labels"][:, :a.cfg.num_patch_tokens] = 0
        with torch.no_grad():
            again, _ = model.loss(params, tb)
        assert float(again) == float(total)


@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The trainer's path (``loss(kernels=False)``, what
    ``make_train_step`` differentiates) against ``jax.value_and_grad`` of
    the reference's loss: the loss to 2e-5 and every gradient leaf within
    2e-4 of its largest; vlm with remat on both sides."""
    kw = {"remat": True} if arch == VLM else {}
    jcfg, cfg = reduced_pair(arch, **kw)
    a = _arch(arch)
    jb, tb = _batches(a.batch)
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(
        jax_build_model(jcfg).loss, has_aux=True))(a.jparams, jb)
    params = _params(a)
    leaves = list(optim.adamw.tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    total, _ = model_mod.build_model(cfg, "cpu").loss(params, tb,
                                                      kernels=False)
    total.backward()
    assert abs(float(total.detach()) - float(jtotal)) <= TOL * (
        1 + abs(float(jtotal)))
    # the audio embedding table is read by no loss term (the frames are an
    # input, the head is untied): no grad, a zero gradient in JAX, and
    # the trainer steps it with zeros
    grads = ckpt.flatten_tree(optim.adamw.tree_map(
        lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
        params))
    want = ckpt.flatten_tree(bridge.from_jax_params(
        jax.tree.map(np.asarray, jgrads), cfg, "cpu"))
    assert sorted(grads) == sorted(want)
    for k, w in want.items():
        w = w.numpy()
        err = float(np.abs(grads[k].numpy() - w).max())
        assert err <= GRAD_TOL * max(float(np.abs(w).max()), 1e-6), k


@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_prefill_then_decode_match_reference(arch):
    """``prefill`` of the whole input (vlm: patches, text and M-RoPE
    positions; audio: frames), then four ``decode_step``s of the JAX
    side's greedy tokens (vlm at M-RoPE positions continuing at (p, p,
    p); audio embedding the codec tokens with the sinusoidal table at
    ``lengths``): logits at 2e-5 at every step."""
    a = _arch(arch)
    batch = {k: v for k, v in a.batch.items() if k != "labels"}
    jb, tb = _batches(batch)
    s = S_AUDIO if arch == AUDIO else a.cfg.num_patch_tokens + TEXT
    cache_len = s + 2 * DECODE_STEPS
    model = model_mod.build_model(a.cfg, "cpu")
    params = _params(a)
    jprefill = jax.jit(a.jmodel.prefill)
    jdecode = jax.jit(a.jmodel.decode_step)
    jlogits, jcache = jprefill(a.jparams, jb,
                               a.jmodel.init_cache(B, cache_len))
    cache = model.init_cache(B, cache_len)
    with torch.no_grad():
        logits = model.prefill(params, tb, cache)
    _close(logits, jlogits)
    nxt = int(batch["mrope_positions"][0, -1, 0]) + 1 if arch == VLM else 0
    for i in range(DECODE_STEPS):
        tok = np.asarray(jnp.argmax(
            jlogits[:, -1, :a.cfg.vocab_size], -1)).astype(np.int32)[:, None]
        step = {"tokens": tok,
                "lengths": np.full((B,), s + i, np.int32)}
        if arch == VLM:
            step["mrope_positions"] = np.full((B, 1, 3), nxt + i, np.int32)
        jstep, tstep = _batches(step)
        jlogits, jcache = jdecode(a.jparams, jcache, jstep)
        with torch.no_grad():
            logits = model.decode_step(params, cache, tstep)
        _close(logits, jlogits)


@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_bridge_and_weight_bytes_match_reference(arch):
    """``from_jax_params`` copies every leaf (QKV biases, layernorm's scale
    and bias, the untied head) bit for bit into the tree ``Model.init``
    builds; ``model_weight_bytes`` equals the reference's and the leaves'
    bytes, at the reduced size and (over the meta-tensor tree) the full
    one."""
    a = _arch(arch)
    params = _params(a)
    want = ckpt.flatten_tree(jax.tree.map(np.asarray, a.jparams))
    got = ckpt.flatten_tree(params)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w)
    init = ckpt.flatten_tree(model_mod.build_model(a.cfg, "cpu").init(
        torch.Generator().manual_seed(0)))
    assert {k: (v.shape, v.dtype) for k, v in init.items()} == {
        k: (v.shape, v.dtype) for k, v in got.items()}
    own = ("blocks//ln1//scale", "blocks//ln1//bias") if arch == AUDIO \
        else ("blocks//attn//bq", "blocks//attn//bk", "blocks//attn//bv")
    assert set(own) <= set(got)
    assert got["lm_head"].shape == (a.cfg.d_model, a.cfg.vocab_padded)
    for cfg, jcfg in ((a.cfg, a.jcfg), (get_config(arch),
                                        jax_get_config(arch))):
        nbytes = perf_model.model_weight_bytes(cfg)
        assert nbytes == jax_perf_model.model_weight_bytes(jcfg)
        leaves = ckpt.flatten_tree(sharding.meta_params(cfg)).values()
        assert nbytes == sum(t.numel() * t.element_size() for t in leaves)


def test_audio_train_matches_reference(monkeypatch, capsys):
    """``train()`` of the reduced musicgen for two steps on the same seed
    (the port's init replaced by the JAX init's weights, bridged): each
    step's frames are the current embedding table's rows of the
    pipeline's tokens, so the losses agree to 2e-5 at both steps."""
    a = _arch(AUDIO)
    kw = dict(steps=2, global_batch=2, seq_len=32, lr=1e-3, log_every=1)
    _, jhist = jax_train.train(a.jcfg, **kw)
    monkeypatch.setattr(model_mod.Model, "init",
                        lambda self, gen=None, mesh=None, keep=None:
                        _params(a))
    params, hist = train_mod.train(a.cfg, device="cpu", **kw)
    assert len(hist) == len(jhist) == 2
    for h, jh in zip(hist, jhist):
        for key in ("loss", "ce", "lr"):
            assert abs(h[key] - jh[key]) <= TOL * (1 + abs(jh[key])), key
    assert not params["embed"].requires_grad
    capsys.readouterr()


def test_vlm_train_is_refused_where_the_reference_fails(capsys):
    """The reference's launcher feeds a vlm model token batches and dies
    on ``patch_embeds``; the port's ``train()`` raises a ``ValueError``
    that names it."""
    a = _arch(VLM)
    with pytest.raises(KeyError, match="patch_embeds"):
        jax_train.train(a.jcfg, steps=1, global_batch=1, seq_len=8)
    with pytest.raises(ValueError, match="patch_embeds"):
        train_mod.train(a.cfg, steps=1, global_batch=1, seq_len=8,
                        device="cpu")
    capsys.readouterr()


@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_engine_and_launcher_refuse_where_the_reference_fails(arch, capsys):
    """The reference's engine takes these families (the two-program path)
    and its first step raises ``KeyError`` on the prefill's input; its
    serve launcher the same.  The port's engine and launcher raise a
    ``ValueError`` naming that key at construction; with the paged pool
    both raise the reference's "paged KV cache requires" error."""
    a = _arch(arch)
    jeng = JaxServingEngine(a.jcfg, JaxEngineConfig(
        max_batch=1, prefill_len=8, max_cache=16, async_steps=False),
        params=a.jparams)
    jeng.submit(np.arange(8, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(KeyError, match=KEY[arch]):
        jeng.run_until_done()
    with pytest.raises(KeyError, match=KEY[arch]):
        jax_serve.serve_demo(a.jcfg, requests=1, new_tokens=2, prompt_len=8)
    with pytest.raises(ValueError, match="paged KV cache requires"):
        JaxServingEngine(a.jcfg, JaxEngineConfig(paged=True))
    with pytest.raises(ValueError, match=KEY[arch]):
        ServingEngine(a.cfg, EngineConfig(paged=False), device="cpu")
    with pytest.raises(ValueError, match=KEY[arch]):
        serve_mod.serve_demo(a.cfg, requests=1, new_tokens=2, prompt_len=8,
                             device="cpu")
    with pytest.raises(ValueError, match="paged KV cache requires"):
        ServingEngine(a.cfg, EngineConfig(), device="cpu")
    capsys.readouterr()


@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_forward_routed_is_refused_as_the_reference_refuses_it(arch):
    a = _arch(arch)
    tokens = np.zeros((1, 2), np.int32)
    one = np.ones((1,), np.int32)
    jb, tb = _batches({"tokens": tokens, "lengths": 0 * one,
                       "seg_lens": one})
    match = "token-input attention families"
    with pytest.raises(NotImplementedError, match=match):
        a.jmodel.forward_routed(a.jparams, jb, a.jmodel.init_cache(1, 4))
    model = model_mod.build_model(a.cfg, "cpu")
    with pytest.raises(NotImplementedError, match=match):
        model.forward_routed(_params(a), tb, model.init_cache(1, 4))


@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_engine_on_a_mesh_refuses_where_the_reference_fails(arch):
    """On a mesh too the engine refuses these families with the
    ``ValueError`` naming the prefill's input (C3: the reference's engine
    fails on that key), before it draws a weight or runs a collective;
    they serve on a mesh through ``prefill`` and ``decode_step``
    (``tests/test_torch_families_mesh.py``)."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": 2},
                                 coords={"data": 0, "model": 0})
    with pytest.raises(ValueError, match=KEY[arch]):
        ServingEngine(_arch(arch).cfg, EngineConfig(paged=False),
                      device="cpu", mesh=mesh)
