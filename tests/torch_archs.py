"""The archs the port runs, and the reduced configs its CPU parity tests
hold against the JAX reference.

``reduced()`` gives every arch all-live experts (4 of 4) and an unpadded
512-token vocab, so for the archs that have them at full size (granite's
router-dead experts and padded vocab, DBRX's layernorm and widths) the
tests take a variant with both: 6 live experts of 8 and a 500-token vocab
padded to 512, identically on both sides."""
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro_torch.configs.base import get_config

ARCHS = ("qwen3_moe_30b_a3b", "granite_moe_3b_a800m", "dbrx")
NEW_ARCHS = ARCHS[1:]
# the dense family (slice 6): reduced() as it is, on both sides
DENSE_ARCHS = ("qwen3_0_6b", "stablelm_12b")
# slice 11: the last two dense configs (QKV bias; neither bias nor
# qk-norm), and the stateful families (hybrid, ssm)
LATE_DENSE_ARCHS = ("qwen2_72b", "deepseek_67b")
FAMILY_ARCHS = ("recurrentgemma_2b", "mamba2_130m")
# slice 12: the vlm and audio families
MODALITY_ARCHS = ("qwen2_vl_7b", "musicgen_large")
DEAD_AND_PADDED = dict(num_experts=6, num_experts_padded=8, vocab_size=500)


def reduced_pair(arch: str, jax_kw: dict | None = None, **kw):
    """(JAX config, port config) of ``arch`` reduced, with ``kw`` on both
    sides and ``jax_kw`` (the JAX-only kernel switches) on the JAX side;
    granite and DBRX take the dead-expert, padded-vocab variant."""
    extra = DEAD_AND_PADDED if arch in NEW_ARCHS else {}
    jcfg = jax_get_config(arch).reduced().replace(**extra, **kw,
                                                  **(jax_kw or {}))
    return jcfg, get_config(arch).reduced().replace(**extra, **kw)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's tests on one intra-op thread, restored after.  The
    port's CPU tests are many small ops, and under pytest-xdist every
    worker's default pool (one thread a core) spins against the others':
    with six workers on eight cores a test file ran about 2.5 times
    slower than on one thread.  A test module opts in by importing this
    fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
