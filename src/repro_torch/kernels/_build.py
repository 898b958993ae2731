"""Builds a kernel's CUDA source into a shared library and loads it.

Each kernel under ``kernels/*/csrc/`` exposes a plain C function, so it is
compiled by ``nvcc`` alone (no PyTorch headers, seconds per file) into
``build/repro_torch/`` at the repository root and bound with ``ctypes``.
The library is keyed by a hash of its source, the headers it includes with
``#include "..."`` and the flags, so an edited source or header is rebuilt
and an unchanged one is reused; nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v", "-lineinfo")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_LIBS: dict[Path, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); CUDA kernels are "
                       "built on the machine with the card")


_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.MULTILINE)


def source_bytes(source: Path, seen: set[Path] | None = None) -> bytes:
    """``source`` followed by every header it includes with quotes,
    recursively (each file once): what a build of it depends on."""
    seen = set() if seen is None else seen
    source = source.resolve()
    if source in seen:
        return b""
    seen.add(source)
    text = source.read_bytes()
    return text + b"".join(source_bytes(source.parent / m.decode(), seen)
                           for m in _INCLUDE.findall(text))


def build(source: Path) -> tuple[Path, str]:
    """Compile ``source`` for sm_90a unless an identical build exists.
    Returns the library path and the compiler's report (registers, shared
    memory and spills per kernel; empty when the build was reused)."""
    source = Path(source).resolve()
    cmd_flags = ARCH_FLAGS + NVCC_FLAGS
    key = hashlib.sha256(source_bytes(source)
                         + " ".join(cmd_flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{key}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *cmd_flags, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)       # atomic: a concurrent build never sees half
    return out, proc.stdout + proc.stderr


def load(source: Path) -> ctypes.CDLL:
    """The loaded library for ``source``, built on first use."""
    source = Path(source).resolve()
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)[0]))
            _LIBS[source] = lib
    return lib
