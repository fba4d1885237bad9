"""Build a CUDA source (``ldso_tpu_torch/csrc/*.cu``) and load it with ctypes.

Each kernel source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into
``.build/ldso_tpu_torch/`` at the root of the checkout. The library's file
name carries a hash of the source and the flags, so an edited source is
never served stale. A build may add preprocessor defines (``defines``,
e.g. ``("TRACK_LEVEL_PHASES",)`` for an instrumented second library); they
are part of the flags, so of the hash. Nothing is compiled or loaded at
import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), ".build", "ldso_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def csrc(module_file: str, name: str) -> str:
    """Path of ``csrc/<name>`` in the package that holds ``module_file``
    (a wrapper's ``__file__``, so that a wrapper loaded from another
    checkout builds that checkout's source)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(module_file))),
                        "csrc", name)


def _flags(defines: tuple) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def build(src: str, defines: tuple = ()) -> str:
    """Compile the source at ``src`` (if not already built from the same
    text and flags) into ``libldso_<stem>_<hash>.so`` and return its path."""
    with open(src, "rb") as f:
        text = f.read()
    flags = _flags(defines)
    tag = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    lib = os.path.join(BUILD_DIR, f"libldso_{stem}_{tag}.so")
    if os.path.isfile(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    subprocess.run([nvcc(), *flags, "-o", tmp, src], check=True)
    os.replace(tmp, lib)
    return lib


def ptxas_report(src: str, defines: tuple = ()) -> str:
    """What ``ptxas -v`` says of the source at ``src``: registers, shared
    memory and spills of each kernel (no library is written)."""
    out = subprocess.run([nvcc(), *_flags(defines), "-Xptxas", "-v", "-o", os.devnull, src],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{out.stdout}{out.stderr}")
    return out.stdout + out.stderr


@functools.lru_cache(maxsize=None)
def load(src: str, defines: tuple = ()) -> ctypes.CDLL:
    """The library of the source at ``src`` (with ``defines``), built if
    need be, loaded once."""
    return ctypes.CDLL(build(src, defines))
