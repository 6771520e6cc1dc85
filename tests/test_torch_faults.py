"""The repairs of three faults of the port against the reference.

* The served store without fp32 copies: ``quant.dot_f32`` (fp32 output,
  the weight copied to fp32 a column block at a time), the column-blocked
  ``quant.qdot`` / ``qdot_f32`` and the LM head, and ``moe.gather_moe``
  gathering in the weights' own dtype, each held to the form it replaced
  and to the JAX package's ``quant.qdot`` / ``gather_moe`` on the same
  weights; on the meta device (as the dry-run reads the card's program)
  their op streams hold no fp32 tensor beyond one block and peak within
  the bound of their shapes, and the dry-run's decode step of DBRX int4
  at four rows and of qwen2-72b int8 fits the card.
* Deterministic dispatch gradients: ``moe.dispatch_rows`` and
  ``moe.combine_rows`` against ``index_select``'s gradients, and a
  captured backward of ``dispatch_moe`` holding no atomic-add op.
* The trainer's expert FFN a block of experts at a time
  (``moe.expert_ffn(kernels=False)``): its output and every gradient bit
  for bit those of the whole-stack fp32 copies it replaced, and one
  reduced MoE layer's forward and backward peaking lower by at least the
  stack's fp32 bytes less one block's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import moe as jax_moe
from repro.core import quant as jq
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.core import expert_parallel, moe, quant
from repro_torch.launch import dryrun, opcount, sharding
from torch_archs import one_torch_thread  # noqa: F401  (autouse below)

LEVELS = ["none", "int8", "int4"]
# the JAX side jitted whole: one compile a case, not one a primitive
jq_quantize = jax.jit(jq.quantize, static_argnames=("level", "block"))
jax_gather = jax.jit(jax_moe.gather_moe, static_argnums=4)
jax_qdot = jax.jit(lambda x, w: jq.qdot("bsd,dv->bsv", x, w))
jax_head = jax.jit(lambda x, w: jq.qdot(
    "bsd,dv->bsv", x, w, weight_dtype=jnp.bfloat16,
    preferred_element_type=jnp.float32))
TOL = dict(rtol=1e-5, atol=1e-5)          # the port's fp32 tolerance
CARD_BYTES = 80e9                          # an H100's 80 GB


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    yield


def _weight(rng, shape, level):
    """(JAX weight, port weight) of the same numpy values: raw fp32, or
    quantized alike on both sides (bit for bit, block 32)."""
    w = rng.standard_normal(shape).astype(np.float32) * shape[-2] ** -0.5
    if level == "none":
        return jnp.asarray(w), torch.from_numpy(w)
    return (jq_quantize(jnp.asarray(w), level=level, block=32),
            quant.quantize(torch.from_numpy(w), level, block=32))


def _old_qdot(x, w):
    """The form ``quant.qdot`` replaced: the whole matrix dequantized."""
    return x @ quant.materialize(w)


def _old_head(x, w):
    """The LM head's replaced form: fp32 copies of the operands."""
    return x.float() @ quant.materialize(w, x.dtype).to(x.dtype).float()


@pytest.fixture
def small_chunk(monkeypatch):
    """Blocks of a few columns, so every product runs blocked."""
    monkeypatch.setattr(quant, "BLOCK_BYTES", 16 * 96 * 7)


@pytest.mark.parametrize("level", LEVELS)
def test_blocked_qdot_matches_whole_and_reference(level, small_chunk):
    rng = np.random.default_rng(0)
    jw, tw = _weight(rng, (96, 50), level)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    got = quant.qdot(torch.from_numpy(x), tw)
    np.testing.assert_allclose(got.numpy(), _old_qdot(
        torch.from_numpy(x), tw).numpy(), **TOL)
    want = jax_qdot(jnp.asarray(x), jw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("level", LEVELS)
def test_blocked_head_matches_whole_and_reference(level, small_chunk):
    """The LM head's product: the weight taken in x's dtype (bf16), fp32
    output, against the replaced fp32-copy form and the reference's
    ``qdot(weight_dtype=x.dtype, preferred_element_type=float32)``."""
    rng = np.random.default_rng(1)
    jw, tw = _weight(rng, (96, 300), level)
    x = rng.standard_normal((2, 3, 96)).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    got = quant.qdot_f32(xt, tw, torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _old_head(xt, tw).numpy(), **TOL)
    want = jax_head(jnp.asarray(x, jnp.bfloat16), jw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dot_f32_blocks_equal_the_whole_copy(monkeypatch):
    """The helper is the fp32-copy form, bit for bit, for a weight within
    one block, and within fp32 rounding of it a column block at a time
    (a matrix and a stack)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((64, 40)).astype(
        np.float32)).bfloat16()
    w3 = torch.stack([w, w.flip(0)])
    x3 = x[:2, None]
    assert torch.equal(quant.dot_f32(x, w), x.float() @ w.float())
    assert torch.equal(quant.dot_f32(x3, w3), x3.float() @ w3.float())
    monkeypatch.setattr(quant, "BLOCK_BYTES", 4 * 64 * 7)
    np.testing.assert_allclose(quant.dot_f32(x, w).numpy(),
                               (x.float() @ w.float()).numpy(), **TOL)
    np.testing.assert_allclose(quant.dot_f32(x3, w3).numpy(),
                               (x3.float() @ w3.float()).numpy(), **TOL)
    cap = opcount.capture(quant.dot_f32, x, w)
    _no_fp32_over(cap.records, max(64 * 7, x.numel()))


@pytest.mark.parametrize("level", LEVELS)
def test_gather_moe_matches_old_form_and_reference(level, small_chunk):
    """bf16 activations over bf16-rounded (or quantized) experts, a
    dead-routed token: the reference's gather and the replaced form (fp32
    copies of the gathered slice)."""
    rng = np.random.default_rng(3)
    e, d, f, t, k = 4, 96, 64, 5, 2
    ws = {n: _weight(rng, s, level) for n, s in (
        ("w_gate", (e, d, f)), ("w_up", (e, d, f)), ("w_down", (e, f, d)))}
    if level == "none":
        ws = {n: (jnp.asarray(w, jnp.bfloat16), t_.bfloat16())
              for n, (w, t_) in ws.items()}
    jex = {n: v[0] for n, v in ws.items()}
    tex = {n: v[1] for n, v in ws.items()}
    x = rng.standard_normal((t, d)).astype(np.float32)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
        np.int32)
    idx[3] = e                                     # the E_pad sentinel
    tw = rng.random((t, k)).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    got = moe.gather_moe(tex, xt, torch.from_numpy(idx).long(),
                         torch.from_numpy(tw), 0).float()
    sel = lambda n: quant.materialize(
        tex[n][torch.from_numpy(idx).clamp(max=e - 1).long()]).float()
    g = torch.einsum("td,tkdf->tkf", xt.float(), sel("w_gate"))
    u = torch.einsum("td,tkdf->tkf", xt.float(), sel("w_up"))
    h = (torch.nn.functional.silu(g) * u).to(xt.dtype)
    y = torch.einsum("tkf,tkfd->tkd", h.float(), sel("w_down"))
    wt = torch.where(torch.from_numpy(idx) < e, torch.from_numpy(tw), 0.0)
    old = torch.einsum("tk,tkd->td", wt, y).to(xt.dtype).float()
    np.testing.assert_allclose(got.numpy(), old.numpy(), **TOL)
    want = jax_gather(jex, jnp.asarray(x, jnp.bfloat16), jnp.asarray(idx),
                      jnp.asarray(tw), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL)
    assert np.all(got.numpy()[3] == 0.0)


def _meta_quant(shape, level, block=32):
    return quant.quantize(torch.empty(shape, dtype=torch.bfloat16,
                                      device="meta"), level, block=block)


def _no_fp32_over(records, elems: int) -> None:
    """No op of the stream made an fp32 tensor of more than ``elems``
    elements (one block's dequantize goes through fp32, as the
    reference's does; nothing larger may)."""
    big = [r.line for r in records for s, dt in zip(r.out_shapes,
                                                    r.out_dtypes)
           if dt == torch.float32 and int(np.prod(s)) > elems]
    assert not big, big


@pytest.mark.parametrize("level", ["int8", "int4"])
def test_blocked_head_peak_on_meta(level, monkeypatch):
    """The head's product on the meta device: its peak is the fp32 logits
    plus one block's temporaries (16 B an element, as
    ``sharding.serve_peak_bytes`` counts them), and no fp32 tensor larger
    than a block is ever made."""
    d, v, rows, cols = 256, 4096, 4, 128
    monkeypatch.setattr(quant, "BLOCK_BYTES", 16 * d * cols)
    w = _meta_quant((d, v), level)
    x = torch.empty((2, rows // 2, d), dtype=torch.bfloat16, device="meta")
    cap = opcount.capture(quant.qdot_f32, x, w, torch.bfloat16)
    assert "mm" in {r.name for r in cap.records}
    bound = 4 * rows * v + 16 * d * cols
    assert cap.peak_bytes <= bound
    assert cap.peak_bytes < 4 * d * v              # the old fp32 copy
    _no_fp32_over(cap.records, d * cols)


@pytest.mark.parametrize("level", ["none", "int8", "int4"])
def test_gather_moe_peak_on_meta(level, monkeypatch):
    """A decode step's gather on the meta device, at blocks of 16 B x one
    matrix: the transient is the gathered slice of one stack in the
    weights' dtype (bf16), its payload and scales, and one block's
    dequantize temporaries (one matrix) or fp32 copy (four matrices); no
    fp32 tensor beyond one block."""
    e, d, f, t, k = 8, 256, 512, 8, 2
    monkeypatch.setattr(quant, "BLOCK_BYTES", 16 * d * f)
    mk = (lambda s: torch.empty(s, dtype=torch.bfloat16, device="meta")) \
        if level == "none" else (lambda s: _meta_quant(s, level))
    ex = {"w_gate": mk((e, d, f)), "w_up": mk((e, d, f)),
          "w_down": mk((e, f, d))}
    x = torch.empty((t, d), dtype=torch.bfloat16, device="meta")
    idx = torch.empty((t, k), dtype=torch.long, device="meta")
    tw = torch.empty((t, k), dtype=torch.float32, device="meta")
    cap = opcount.capture(moe.gather_moe, ex, x, idx, tw, 0)
    sel = t * k
    packed = (quant.tree_bytes({"w": ex["w_down"][0]})
              if level != "none" else 0)
    small = 16 * sel * (f + d)                     # g, u, h, x and y rows
    bound = sel * (2 * d * f + packed) + 16 * d * f + small
    assert cap.peak_bytes <= bound
    assert cap.peak_bytes < 4 * sel * d * f        # an fp32 copy of it
    _no_fp32_over(cap.records, 4 * d * f)


@pytest.mark.parametrize("arch,level", [("dbrx", "int4"),
                                        ("qwen2_72b", "int8")])
def test_dryrun_decode_fits_the_card(arch, level):
    """The dry-run's decode step at four rows of 2048 cached tokens, one
    device: a peak under the card's memory, its temporaries within
    ``sharding.serve_peak_bytes``'s transient and activation terms."""
    shape = ShapeSpec("decode_b4", "decode", 2048, 4)
    rec = dryrun.run_pair(arch, "decode_b4", (1, 1), ("data", "model"),
                          cfg_overrides={"weight_quant": level},
                          shape=shape)
    assert rec["ok"], rec.get("error")
    mem = rec["memory"]
    assert mem["peak_per_device"] < CARD_BYTES
    cfg = get_config(arch).replace(weight_quant=level)
    store = quant.tree_bytes(sharding.meta_params(cfg))
    assert mem["argument_bytes"] > store
    over = sharding.serve_peak_bytes(cfg, rows=4, chunk_len=1,
                                     pool_bytes=0) - store
    assert mem["temp_bytes"] <= over


class _AtomicOps(TorchDispatchMode):
    """The aten ops that add into an output with atomics on the card:
    ``index_add``, ``index_put`` with accumulate, ``scatter_add`` (and
    ``scatter`` with a reduce), ``_index_put_impl_`` accumulating."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        accumulate = kwargs.get("accumulate", False) or (
            name.startswith(("index_put", "_index_put_impl"))
            and len(args) > 3 and bool(args[3]))
        if (name.startswith(("index_add", "scatter_add", "scatter_reduce"))
                or (name.startswith(("index_put", "_index_put_impl"))
                    and accumulate)):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def _dispatch_case(seed=4, t=24, d=16, e=4, k=2, cap=8):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    idx = torch.from_numpy(np.stack([rng.permutation(e)[:k]
                                     for _ in range(t)]))
    idx[5] = e                                     # a dead-routed token
    tw = torch.from_numpy(rng.random((t, k)).astype(np.float32))
    ex = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for n, s in (("w_gate", (e, d, 12)), ("w_up", (e, d, 12)),
                       ("w_down", (e, 12, d)))}
    return x, idx, tw, ex, cap


def test_dispatch_gathers_match_index_select_gradients():
    """The forward values are ``index_select``'s bit for bit; the
    dispatch gradient is each token's sum over its slots (within fp32
    rounding of ``index_select``'s atomic sum), the combine gradient the
    one decision each slot holds (exact), with capacity drops."""
    x, idx, tw, ex, cap = _dispatch_case()
    tok, valid, slot_of = moe.make_dispatch_plan(idx, 4, 0, 4, cap // 2)
    assert (slot_of == 4 * (cap // 2)).any()       # some decisions drop
    xa = x.clone().requires_grad_(True)
    xb = x.clone().requires_grad_(True)
    got = moe.dispatch_rows(xa, tok, valid, slot_of)
    want = xb.index_select(0, tok) * valid[:, None].to(x.dtype)
    assert torch.equal(got, want)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(got.shape)).astype(np.float32))
    got.backward(g)
    want.backward(g)
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    ye = torch.randn(tok.shape[0], x.shape[1], requires_grad=True)
    yb = ye.detach().clone().requires_grad_(True)
    got = moe.combine_rows(ye, slot_of)
    pad = torch.cat([yb, yb.new_zeros((1, yb.shape[1]))])
    want = pad.index_select(0, slot_of.reshape(-1)).reshape(got.shape)
    assert torch.equal(got, want)
    gy = torch.randn(got.shape)
    got.backward(gy)
    want.backward(gy)
    assert torch.equal(ye.grad, yb.grad)
    assert torch.equal(ye.grad[~valid], torch.zeros_like(ye.grad[~valid]))


def test_dispatch_moe_backward_has_no_atomic_adds():
    """A captured backward of ``dispatch_moe`` (the trainer's path,
    kernels=False) holds no atomic-add op; the same capture of the
    ``index_select`` form it replaced shows them, so the capture sees
    such ops where they are."""
    x, idx, tw, ex, cap = _dispatch_case()
    params = {n: v.clone().requires_grad_(True) for n, v in ex.items()}
    xg = x.clone().requires_grad_(True)
    y = moe.dispatch_moe(params, xg, idx, tw, 4, 0, cap, kernels=False)
    with _AtomicOps() as mode:
        y.square().sum().backward()
    assert mode.seen == []
    assert xg.grad is not None and params["w_gate"].grad is not None
    xo = x.clone().requires_grad_(True)
    tok, valid, slot_of = moe.make_dispatch_plan(idx, 4, 0, 4, cap)
    xe = xo.index_select(0, tok) * valid[:, None].to(x.dtype)
    with _AtomicOps() as mode:
        xe.square().sum().backward()
    assert mode.seen


# ---------------------------------------------------------------------------
# the trainer's expert FFN, a block of experts at a time
# ---------------------------------------------------------------------------

def _whole_copy_ffn(experts, xe, kernels=False):
    """The form ``moe.expert_ffn(kernels=False)`` replaced: fp32 copies of
    the three whole stacks, differentiated by autograd."""
    w = lambda name: quant.materialize(experts[name]).float()
    xf = xe.float()
    g = torch.bmm(xf, w("w_gate"))
    u = torch.bmm(xf, w("w_up"))
    h = (torch.nn.functional.silu(g) * u).to(xe.dtype)
    return torch.bmm(h.float(), w("w_down")).to(xe.dtype)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_expert_ffn_equals_whole_copy(level, dtype, monkeypatch):
    """Two experts a block over six (one of them router-dead: an all-zero
    slice whose gradients must stay exactly zero): the output, x's
    gradient and each weight's gradient (raw stacks; a QuantTensor has
    none) bit for bit the whole-copy form's, each in its own dtype."""
    e, c, d, f = 6, 5, 32, 48
    monkeypatch.setattr(moe, "FFN_BLOCK_BYTES", 2 * 3 * d * f * 4)
    assert moe.experts_per_block(d, f) == 2
    rng = np.random.default_rng(11)
    shapes = {"w_gate": (e, d, f), "w_up": (e, d, f), "w_down": (e, f, d)}
    x0 = rng.standard_normal((e, c, d)).astype(np.float32)
    x0[-1] = 0
    gy = torch.from_numpy(rng.standard_normal((e, c, d)).astype(
        np.float32)).to(dtype)
    gy[-1] = 0
    base = {k: torch.from_numpy((rng.standard_normal(shape)
                                 * shape[-2] ** -0.5).astype(np.float32))
            for k, shape in shapes.items()}
    out = []
    for fn in (_whole_copy_ffn, moe.expert_ffn):
        if level == "none":
            ex = {k: v.to(dtype).requires_grad_() for k, v in base.items()}
        else:
            ex = {k: quant.quantize(v.to(dtype), level, block=16)
                  for k, v in base.items()}
        x = torch.from_numpy(x0).to(dtype).requires_grad_()
        y = fn(ex, x, kernels=False)
        y.backward(gy)
        out.append([y.detach(), x.grad] + [
            w.grad for w in ex.values() if isinstance(w, torch.Tensor)])
    for want, got in zip(*out):
        assert got.dtype == want.dtype == dtype
        assert torch.equal(got, want)
    for g in out[1][2:]:
        assert bool((g[-1] == 0).all())


def test_blocked_expert_ffn_lowers_the_layer_peak(monkeypatch):
    """One reduced granite MoE layer (8 experts, D 256, F 512, bf16: the
    dtype whose fp32 copies are real) through
    ``expert_parallel.moe_layer(kernels=False)`` under ``opcount``'s
    capture, one expert a block, against the whole-copy form:

    * after the forward, the bytes it keeps for the backward fall by at
      least the stack's fp32 bytes (the whole-copy form saves its three
      copies; the blocked one saves none);
    * the peak of the forward and backward falls by at least the stack's
      fp32 bytes less one block's, less the stacks' gradients in their
      own dtype: the blocked backward writes those whole before its first
      block, where the whole-copy form had made only some of its own at
      its peak (both end holding all of them);
    * the gradients are the same, bit for bit."""
    cfg = get_config("granite_moe_3b_a800m").reduced().replace(
        num_experts=6, num_experts_padded=8, dtype="bfloat16")
    e, d, f = cfg.num_experts_padded, cfg.d_model, cfg.d_ff
    block = 3 * d * f * 4
    monkeypatch.setattr(moe, "FFN_BLOCK_BYTES", block)
    rng = np.random.default_rng(12)
    mk = lambda shape, s: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).to(
        torch.bfloat16)
    layer = {"router": mk((d, e), d ** -0.5),
             "experts": {"w_gate": mk((e, d, f), d ** -0.5),
                         "w_up": mk((e, d, f), d ** -0.5),
                         "w_down": mk((e, f, d), f ** -0.5)}}
    x0 = mk((2, 16, d), 1.0)

    def forward():
        # a layer's input is an activation: it takes a gradient too
        p = {"router": layer["router"].clone().requires_grad_(),
             "experts": {k: v.clone().requires_grad_()
                         for k, v in layer["experts"].items()}}
        x = x0.clone().requires_grad_()
        y, aux, _ = expert_parallel.moe_layer(cfg, p, x, kernels=False)
        return y.float().square().mean() + aux, p, x

    def step():
        loss, p, x = forward()
        loss.backward()
        return [x.grad, p["router"].grad] + [
            p["experts"][k].grad for k in ("w_gate", "w_up", "w_down")]

    kept_new = opcount.capture(forward).live_bytes
    new = opcount.capture(step)
    monkeypatch.setattr(moe, "expert_ffn", _whole_copy_ffn)
    kept_old = opcount.capture(forward).live_bytes
    old = opcount.capture(step)
    for a, b in zip(old.result, new.result):
        assert torch.equal(a, b)
    stack = 3 * e * d * f * 4
    grads = 3 * e * d * f * 2
    assert kept_old - kept_new >= stack, (kept_old, kept_new)
    assert old.peak_bytes - new.peak_bytes >= stack - block - grads, (
        old.peak_bytes, new.peak_bytes)
