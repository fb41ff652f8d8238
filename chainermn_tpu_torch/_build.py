"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/kernels/<name>-<hash>.so``
at the root of the checkout (``build/`` is git-ignored), and is loaded
with :mod:`ctypes`.  The hash is of the source and of every shared header
``csrc/*.cuh``, so an edited kernel or header is rebuilt and a stale
library is never loaded.  Nothing is built when a
module is imported: the first call of a kernel's wrapper builds it, or
:func:`build_all` builds every kernel at once, one ``nvcc`` per source,
all started together.  Any build or load failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "build_all", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the port's "
            "kernels are built from source on the machine with the card")
    return str(path)


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library is already built;
    returns ``(library path, process or None, temporary path)``."""
    src, lib = _target(name)
    if lib.exists():
        return lib, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, proc, tmp


def _finish(name: str, lib: Path, proc, tmp) -> Path:
    if proc is None:
        return lib
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
    return lib


def build_all() -> list[str]:
    """Compile every ``csrc/*.cu`` in parallel; returns the kernel names."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = [(n, *_start(n)) for n in names]
    errors = []
    for name, lib, proc, tmp in started:   # wait for every nvcc
        try:
            _finish(name, lib, proc, tmp)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return names


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        lib = _finish(name, *_start(name))
        _loaded[name] = ctypes.CDLL(str(lib))
    return _loaded[name]
