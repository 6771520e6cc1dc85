"""Build the hand-written CUDA kernels (``csrc/*.cu``) at first use and load
them with ``ctypes``.

Each source compiles to an object with its own ``nvcc`` process (all started
together), then one shared library with a plain C interface is linked:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC

The library lands in ``<repo>/build/kernels/`` (git-ignored) under a name
keyed by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads at once.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    "moe_ffn_f32": [_P] * 5 + [_I] * 4 + [_P],
    "moe_ffn_bf16": [_P] * 6 + [_I] * 4 + [_P],
    "paged_attention_f32": [_P] * 9 + [_I] * 10 + [ctypes.c_float, _P],
    "paged_attention_bf16": [_P] * 9 + [_I] * 10 + [ctypes.c_float, _P],
    "paged_attention_int8_f32": [_P] * 11 + [_I] * 10 + [ctypes.c_float, _P],
    "paged_attention_int8_bf16": [_P] * 11 + [_I] * 10
    + [ctypes.c_float, _P],
    "moe_ffn_quant_f32": [_P] * 8 + [_I] * 6 + [_P],
    "moe_ffn_quant_bf16": [_P] * 9 + [_I] * 6 + [_P],
    "flash_attention_f32": [_P] * 4 + [_L] * 9 + [_I] * 7
    + [ctypes.c_float, _P],
    "flash_attention_bf16": [_P] * 4 + [_L] * 9 + [_I] * 7
    + [ctypes.c_float, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, dict]:
    """Compile and link the kernels if the hashed library is missing.

    Returns (library path, info) where info holds the build seconds and
    each source's ``-Xptxas -v`` report (registers, shared memory, spills).
    """
    lib = BUILD_DIR / f"libreprokernels-{source_hash()}.so"
    if lib.exists():
        return lib, {"seconds": 0.0, "cached": True, "ptxas": {}}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = {}
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            procs[src.name] = (obj, subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        reports, failed = {}, []
        for name, (_, proc) in procs.items():
            out, _ = proc.communicate()
            reports[name] = out
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                               + "\n".join(reports[n] for n in failed))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *(str(obj) for obj, _ in procs.values())],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        os.replace(tmp_lib, lib)
    return lib, {"seconds": time.perf_counter() - t0, "cached": False,
                 "ptxas": reports}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().kernel_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if autograd would record a call of ``kernel``: its output is a
    fresh tensor with no ``grad_fn``, so gradients would silently skip it.
    No kernel has a backward (the reference's Pallas kernels have none);
    the trainer differentiates the path that reaches no kernel.  Called
    first by every kernel wrapper, before any other check."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"gradients through the {kernel} kernel: no kernel has a "
            f"backward; differentiate the trainer's path, Model.loss(..., "
            f"kernels=False) (launch/train.make_train_step), or call the "
            f"kernel under torch.no_grad()")
