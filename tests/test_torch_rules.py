"""Rules of the PyTorch port: it stands alone beside the JAX package, keeps
the reference configs field for field, and runs on the card by default."""
import ast
import dataclasses
import importlib
from pathlib import Path

import pytest
import torch

from repro.configs import base as jax_base
from repro_torch.configs import base
from torch_archs import (ARCHS, DENSE_ARCHS, FAMILY_ARCHS, LATE_DENSE_ARCHS,
                         MODALITY_ARCHS)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
# switches of the JAX config the port replaces by device dispatch
JAX_ONLY_FIELDS = {"use_kernel", "use_flash_kernel"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path} imports {bad}"


def test_audit_covers_the_package():
    assert len(PORT_FILES) > 15
    assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir()
    serving = ROOT / "src" / "repro_torch" / "serving"
    for name in ("engine.py", "faults.py", "chaos.py", "scheduler.py",
                 "paging.py"):
        assert serving / name in PORT_FILES, name


# the training slice's modules: the card machine has no ml_dtypes, so
# they (and the smoke script) must not need it, bf16 checkpoints included
TRAINING_FILES = [ROOT / "src" / "repro_torch" / f for f in (
    "core/prestack.py", "ckpt/io.py", "data/pipeline.py", "optim/adamw.py",
    "launch/train.py")] + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", TRAINING_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in TRAINING_FILES])
def test_training_modules_need_no_ml_dtypes(path):
    assert path in PORT_FILES
    assert "ml_dtypes" not in _imported_roots(path)


# (arch, reduced); the first arch's cases keep their original ids
CONFIG_CASES = [(a, r) for a in ARCHS + DENSE_ARCHS + LATE_DENSE_ARCHS
                + FAMILY_ARCHS + MODALITY_ARCHS for r in (False, True)]


@pytest.mark.parametrize("arch,reduced", CONFIG_CASES, ids=[
    str(r) if a == ARCHS[0] else f"{a}-{r}" for a, r in CONFIG_CASES])
def test_config_matches_reference_field_by_field(arch, reduced):
    ref = jax_base.get_config(arch)
    port = base.get_config(arch)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    ref_fields = {f.name for f in dataclasses.fields(ref)}
    port_fields = {f.name for f in dataclasses.fields(port)}
    assert ref_fields - port_fields == JAX_ONLY_FIELDS
    assert port_fields <= ref_fields
    for name in sorted(port_fields):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.vocab_padded == ref.vocab_padded
    assert port.n_params() == ref.n_params()
    assert port.n_active_params() == ref.n_active_params()
    assert port.torch_dtype == getattr(torch, port.dtype)


def test_ported_archs_are_registered():
    """Every arch of the reference is ported."""
    ported = (ARCHS + DENSE_ARCHS + LATE_DENSE_ARCHS + FAMILY_ARCHS
              + MODALITY_ARCHS)
    assert base.ARCH_IDS == list(ported)
    assert sorted(base.ARCH_IDS) == sorted(set(jax_base.ARCH_IDS) | {"dbrx"})
    for arch in ported:
        mod = importlib.import_module(f"repro_torch.configs.{arch}")
        assert base.get_config(arch) is mod.CONFIG


@pytest.mark.parametrize("alias,arch", [
    ("dbrx-132b", "dbrx"), ("dbrx", "dbrx"),
    ("granite-moe-3b-a800m", "granite_moe_3b_a800m"),
    ("qwen3-moe-30b-a3b", "qwen3_moe_30b_a3b"),
    ("qwen3-0.6b", "qwen3_0_6b"), ("stablelm-12b", "stablelm_12b"),
    ("qwen2-72b", "qwen2_72b"), ("deepseek-67b", "deepseek_67b"),
    ("recurrentgemma-2b", "recurrentgemma_2b"),
    ("mamba2-130m", "mamba2_130m"), ("qwen2-vl-7b", "qwen2_vl_7b"),
    ("musicgen-large", "musicgen_large")])
def test_get_config_accepts_reference_aliases(alias, arch):
    assert base.get_config(alias) == base.get_config(arch)
    assert base.get_config(alias).name == jax_base.get_config(alias).name


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch 'gpt_2'"):
        base.get_config("gpt_2")


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine
    cfg = base.get_config("qwen3_moe_30b_a3b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)


# the mesh slice: rank processes meet through a file store, never a fixed
# TCP port (concurrent test workers and card runs would collide on one)
RENDEZVOUS_FILES = PORT_FILES + sorted(
    (ROOT / "tests").glob("test_torch_*.py")) + sorted(
    (ROOT / "tests").glob("torch_*.py"))
FIXED_RENDEZVOUS = ("MASTER" + "_PORT", "tcp" + "://", "init" + "_method")


@pytest.mark.parametrize("path", RENDEZVOUS_FILES, ids=[
    str(p.relative_to(ROOT)) for p in RENDEZVOUS_FILES])
def test_no_fixed_rendezvous_port(path):
    text = path.read_text()
    assert not [w for w in FIXED_RENDEZVOUS if w in text], path


def test_mesh_modules_are_audited():
    pkg = ROOT / "src" / "repro_torch"
    for rel in ("launch/mesh.py", "core/collectives.py",
                "core/expert_parallel.py"):
        assert pkg / rel in PORT_FILES, rel
    assert "FileStore" in (pkg / "launch" / "mesh.py").read_text()
