"""Port vs JAX at the model level: the weight bridge, and
``forward_routed`` over the paged pool on the same weights and tokens.

The JAX side runs ``paged_kernel=True`` with ``use_kernel=True`` (its
Pallas kernels in interpret mode on the CPU); the port takes its plain
versions on the CPU.  In fp32, logits agree to 1e-4 (the two sum in
different orders over two layers) and routing decisions are equal; in
bf16 the logits stay fp32, as the reference's do."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.models import layers
from repro_torch.models import model as model_mod
from repro_torch.models.model import build_model
from torch_archs import ARCHS, DENSE_ARCHS, reduced_pair

ARCH = ARCHS[0]


def _configs(arch=ARCH, **kw):
    return reduced_pair(arch, {"use_kernel": True}, capacity_factor=8.0, **kw)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


# (arch, dtype); the first arch's cases keep their original ids
BRIDGE_CASES = [(a, d) for a in ARCHS + DENSE_ARCHS
                for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("arch,dtype", BRIDGE_CASES, ids=[
    d if a == ARCH else f"{a}-{d}" for a, d in BRIDGE_CASES])
def test_bridge_round_trip_bit_exact(arch, dtype):
    """Every leaf, layernorm's scale and bias dicts included, round-trips
    bit for bit."""
    jcfg, cfg = _configs(arch, dtype=dtype, param_dtype=dtype)
    jparams = jax.tree.map(np.asarray,
                           jax_build_model(jcfg).init(jax.random.PRNGKey(1)))
    params = bridge.from_jax_params(jparams, cfg, "cpu")
    back = dict(_leaves(bridge.to_numpy(params)))
    for name, want in _leaves(jparams):
        got = back.pop(name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name
    assert not back
    torch_dtype = getattr(torch, dtype)
    assert all(t.dtype == torch_dtype for _, t in _leaves(params))


def test_bridge_layout_matches_port_init():
    for arch in ARCHS + DENSE_ARCHS:
        jcfg, cfg = _configs(arch)
        params = build_model(cfg, "cpu").init(
            torch.Generator().manual_seed(0))
        shapes = {n: tuple(t.shape) for n, t in _leaves(params)}
        assert shapes == dict(_leaves(bridge.param_shapes(cfg))), arch
        want = jax.eval_shape(jax_build_model(jcfg).init,
                              jax.random.PRNGKey(0))
        assert shapes == {n: a.shape for n, a in _leaves(want)}, arch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    """layernorm (DBRX's norm): fp32 statistics, the biased variance, eps
    1e-5, scale and bias in fp32, the result in x's dtype."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 5, 96)) * 3 + 1.5).astype(np.float32)
    p = {"scale": rng.standard_normal(96).astype(np.float32),
         "bias": rng.standard_normal(96).astype(np.float32)}
    jdt = jnp.dtype(dtype)
    want = np.asarray(jax_layers.layer_norm(
        {k: jnp.asarray(v).astype(jdt) for k, v in p.items()},
        jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = layers.norm_apply("layernorm",
                            {k: torch.from_numpy(v).to(tdt)
                             for k, v in p.items()},
                            torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    init = layers.norm_init("layernorm", 96, tdt, "cpu", (2,))
    assert sorted(init) == ["bias", "scale"]
    assert init["scale"].shape == (2, 96) and bool((init["scale"] == 1).all())
    assert bool((init["bias"] == 0).all()) and init["bias"].dtype == tdt
    assert layers.norm_init("rmsnorm", 96, tdt, "cpu").shape == (96,)


def test_bridge_rejects_other_layout():
    jcfg, cfg = _configs()
    jparams = jax.tree.map(np.asarray,
                           jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="layout"):
        bridge.from_jax_params(jparams, cfg.replace(d_ff=cfg.d_ff * 2), "cpu")


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = _configs()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = bridge.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
    return jmodel, jparams, build_model(cfg, "cpu"), params


def _step(models, state, tokens, lengths, seg_lens, bt):
    jmodel, jparams, model, params = models
    batch = {"tokens": tokens, "lengths": lengths, "seg_lens": seg_lens,
             "block_tables": bt}
    jlogits, state["jcache"], jrouting = jmodel.forward_routed(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        state["jcache"], paged_kernel=True)
    logits, routing = model.forward_routed(
        params, {k: torch.from_numpy(v) for k, v in batch.items()},
        state["cache"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(routing.numpy(), np.asarray(jrouting))
    for leaf in ("k", "v"):
        np.testing.assert_allclose(state["cache"][leaf].numpy(),
                                   np.asarray(state["jcache"][leaf]),
                                   rtol=1e-5, atol=1e-5)
    return np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)


def _fresh(models, num_pages, ps):
    jmodel, _, model, _ = models
    return {"jcache": jmodel.init_paged_cache(num_pages, ps),
            "cache": model.init_paged_cache(num_pages, ps)}


def test_forward_routed_chunked_prefill_then_decode(models):
    """Chunks of 3 over an 8-token prompt, then 4 greedy decode steps, at
    page size 5 (divides neither the prompt nor the 35-slot reach)."""
    b, s, ps, nb = 2, 8, 5, 7
    state = _fresh(models, b * nb, ps)
    toks = np.random.default_rng(0).integers(0, 100, (b, s)).astype(np.int32)
    bt = np.arange(b * nb, dtype=np.int32).reshape(b, nb)
    for lo in range(0, s, 3):
        hi = min(lo + 3, s)
        last = _step(models, state, toks[:, lo:hi],
                     np.full((b,), lo, np.int32),
                     np.full((b,), hi - lo, np.int32), bt)
    for i in range(4):
        last = _step(models, state, last[:, None],
                     np.full((b,), s + i, np.int32), np.ones((b,), np.int32),
                     bt)


def test_forward_routed_mixed_block_shared_pages(models):
    """One block mixing a prefill chunk, a decode row and an empty row,
    with two rows sharing their first page (a prefix hit) and shuffled
    block tables."""
    b, ps, nb, num_pages = 3, 5, 4, 12
    state = _fresh(models, num_pages, ps)
    rng = np.random.default_rng(3)
    bt = rng.permutation(num_pages)[:b * nb].astype(np.int32).reshape(b, nb)
    bt[1, 0] = bt[0, 0]
    prompt = rng.integers(0, 100, (1, 6)).astype(np.int32)
    # row 0 prefills 6 tokens (its first page is row 1's shared prefix)
    _step(models, state, np.repeat(prompt, b, 0),
          np.zeros((b,), np.int32), np.asarray([6, 0, 0], np.int32), bt)
    tokens = rng.integers(0, 100, (b, 4)).astype(np.int32)
    _step(models, state, tokens, np.asarray([6, 5, 0], np.int32),
          np.asarray([1, 4, 0], np.int32), bt)


@pytest.mark.parametrize("tie", [False, True])
def test_lm_head_bf16_logits_stay_fp32(tie):
    """bf16 hidden states and weights give fp32 logits equal to the
    reference's fp32-output product; bf16-rounded logits (errors of about
    2**-9 relative) would fail this tolerance."""
    jcfg, cfg = _configs(dtype="bfloat16", param_dtype="bfloat16",
                         tie_embeddings=tie)
    rng = np.random.default_rng(21)
    d, v = cfg.d_model, cfg.vocab_padded
    bf = lambda a: a.astype(ml_dtypes.bfloat16)
    x = bf(rng.standard_normal((3, 1, d)))
    jparams = {"embed": bf(rng.standard_normal((v, d)) * 0.2)}
    if not tie:
        jparams["lm_head"] = bf(rng.standard_normal((d, v)) / np.sqrt(d))
    want = np.asarray(jax_model._lm_head(
        jcfg, {k: jnp.asarray(a) for k, a in jparams.items()},
        jnp.asarray(x)))
    params = {k: torch.from_numpy(a.astype(np.float32)).bfloat16()
              for k, a in jparams.items()}
    got = model_mod._lm_head(cfg, params,
                             torch.from_numpy(x.astype(np.float32)).bfloat16())
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def bf16_models():
    jcfg, cfg = _configs(dtype="bfloat16", param_dtype="bfloat16")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = bridge.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
    return jmodel, jparams, build_model(cfg, "cpu"), params


def test_forward_routed_bf16_logits_are_fp32(bf16_models):
    """The bf16 main path's logits come out in fp32, not rounded to bf16,
    and stay within the JAX suite's bf16 tolerance of the reference over
    chunked prefill and decode.  (XLA on the CPU skips some of the
    reference's bf16 roundings, so the two bf16 paths agree only to bf16
    tolerance; the tight check of the head is the test above.)"""
    jmodel, jparams, model, params = bf16_models
    b, s, ps, nb = 2, 6, 5, 4
    state = {"jcache": jmodel.init_paged_cache(b * nb, ps),
             "cache": model.init_paged_cache(b * nb, ps)}
    toks = np.random.default_rng(5).integers(0, 100, (b, s)).astype(np.int32)
    bt = np.arange(b * nb, dtype=np.int32).reshape(b, nb)
    steps = [(toks[:, :4], 0, 4), (toks[:, 4:], 4, 2)]
    for i in range(3):
        steps.append((None, s + i, 1))
    last = None
    for tokens, lo, n in steps:
        tokens = last[:, None] if tokens is None else tokens
        batch = {"tokens": tokens, "lengths": np.full((b,), lo, np.int32),
                 "seg_lens": np.full((b,), n, np.int32), "block_tables": bt}
        jlogits, state["jcache"], _ = jmodel.forward_routed(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()},
            state["jcache"], paged_kernel=True)
        logits, _ = model.forward_routed(
            params, {k: torch.from_numpy(v) for k, v in batch.items()},
            state["cache"])
        assert logits.dtype == torch.float32
        on_bf16_grid = (logits == logits.bfloat16().float()).float().mean()
        assert float(on_bf16_grid) < 0.05
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=3e-2, atol=3e-2)
        last = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)


def test_forward_routed_requires_block_tables(models):
    """Without block tables ``forward_routed`` runs over the contiguous
    cache (L, B, S, Hkv, hd), as the reference's does: chunks of 3 over an
    8-token prompt, then greedy decode steps, with the reference's logits
    (1e-4), routing and cache."""
    jmodel, jparams, model, params = models
    b, s, c = 2, 8, 14
    jcache, cache = jmodel.init_cache(b, c), model.init_cache(b, c)
    toks = np.random.default_rng(0).integers(0, 100, (b, s)).astype(np.int32)
    steps = [(toks[:, lo:lo + 3], lo) for lo in range(0, s, 3)]
    last = None
    for i in range(len(steps) + 3):
        if i < len(steps):
            tokens, lo = steps[i]
            n = tokens.shape[1]
            tokens = np.pad(tokens, ((0, 0), (0, 3 - n)))
        else:
            tokens, lo, n = last[:, None], s + i - len(steps), 1
        batch = {"tokens": tokens, "lengths": np.full((b,), lo, np.int32),
                 "seg_lens": np.full((b,), n, np.int32)}
        jlogits, jcache, jrouting = jmodel.forward_routed(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcache)
        logits, routing = model.forward_routed(
            params, {k: torch.from_numpy(v) for k, v in batch.items()},
            cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(routing.numpy(), np.asarray(jrouting))
        for leaf in ("k", "v"):
            np.testing.assert_allclose(cache[leaf].numpy(),
                                       np.asarray(jcache[leaf]),
                                       rtol=1e-5, atol=1e-5)
        last = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)


def test_bf16_params_round_through_ml_dtypes():
    """bf16 tensors leave the port as ml_dtypes bfloat16, as JAX hands
    them out."""
    t = torch.tensor([1.0, -2.5, 3.140625], dtype=torch.bfloat16)
    out = bridge.to_numpy({"w": t})["w"]
    assert out.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(out.astype(np.float32),
                                  t.float().numpy())


def test_padded_vocab_columns_never_win():
    """Granite ties its head to the embedding and pads its vocab (here 500
    to 512): the rows past the vocab are never looked up as inputs, so as
    head columns they only add logits, which greedy decoding must never
    pick and the loss must mask.  Loud rows there win the argmax over the
    padded width, yet change neither the engine's tokens nor the loss."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    _, cfg = _configs("granite_moe_3b_a800m")
    assert cfg.tie_embeddings and cfg.vocab_padded > cfg.vocab_size
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    loud = {**params, "embed": params["embed"].clone()}
    loud["embed"][cfg.vocab_size:] = 1e3 * torch.randn(
        (cfg.vocab_padded - cfg.vocab_size, cfg.d_model),
        generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    with torch.no_grad():
        logits, _ = model.forward(loud, {"tokens": tokens})
        assert float((logits.argmax(-1) >= cfg.vocab_size).float().mean()) > .9
        want, got = model.loss(params, batch)[0], model.loss(loud, batch)[0]
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    prompts = rng.integers(0, cfg.vocab_size, (2, 5))
    streams = []
    for p in (params, loud):
        eng = ServingEngine(cfg, EngineConfig(max_batch=2, max_cache=24),
                            params=p, device="cpu")
        uids = [eng.submit(prompt, 6) for prompt in prompts]
        eng.run_until_done()
        streams.append([eng._all[u].generated for u in uids])
    assert streams[0] == streams[1]
    assert max(max(s) for s in streams[1]) < cfg.vocab_size
