"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``src/repro_torch/csrc/<name>.cu`` exposes a plain C interface (no
PyTorch headers), so ``nvcc`` compiles it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -Xptxas -v -o <build>/lib<name>-<hash>.so <name>.cu

The shared library lands in ``src/repro_torch/_build/`` (listed in
``.gitignore``), named by a hash of its source, so an edited kernel rebuilds
and an unchanged one is reused within a checkout (the hash covers the
shared headers ``csrc/*.cuh`` too).  ``ptxas``'s register and
shared-memory report is kept beside it as ``<lib>.log``.

Nothing here runs at import: the CPU tests import every module, and a
build is only started by a wrapper handed a CUDA tensor (or by
``build_all``).  A build that fails raises; no caller falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(install the CUDA toolkit or put nvcc on PATH)")


def lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc for ``name`` unless its library is already built;
    returns (process or None, output path, temp path)."""
    out = lib_path(name)
    if out.exists():
        return None, out, None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish(name: str, proc, out: Path, tmp: Path) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all(names: Iterable[str]) -> List[Path]:
    """Compile every named source, one nvcc each, all started together."""
    names = list(names)
    started = [(n, *_start(n)) for n in names]
    for name, proc, out, tmp in started:
        _finish(name, proc, out, tmp)
    return [lib_path(n) for n in names]


def load(name: str, argtypes: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed.

    ``argtypes`` maps each C entry point to its argument types; they are set
    once, when the library loads, with an ``int`` (``cudaError_t``) result.
    """
    if name not in _LIBS:
        path, = build_all([name])
        lib = ctypes.CDLL(str(path))
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        lib.errstr.argtypes = [ctypes.c_int]
        lib.errstr.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} ({lib.errstr(err).decode()}) at launch")
