"""Build the port's CUDA sources with nvcc at first use and load them with
ctypes (a shared library with a plain C interface; no PyTorch headers, so
a build takes seconds), and count the kernels' launches.

Libraries go to `moondream_tpu_torch/_build/`, named by a hash of their
sources and flags, so an edited source is rebuilt and a stale library is
never loaded. Nothing is compiled when this module is imported;
`build_parallel` starts one compiler per library at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# seconds spent compiling each library in this process (0.0 when it was
# already built on disk)
build_seconds: Dict[str, float] = {}
# Kernel launches since the last reset_launch_counts(), by kernel name. Each
# wrapper registers its names at import and adds one where it launches.
LAUNCHES: Dict[str, int] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Launches counted since the snapshot `before` (a copy of LAUNCHES)."""
    return {name: n - before.get(name, 0) for name, n in LAUNCHES.items()
            if n != before.get(name, 0)}


def add_launches(delta: Dict[str, int]) -> None:
    """Count the launches a replayed CUDA graph makes: its wrappers counted
    them in Python while it was captured (capture launches nothing, so the
    capture takes them back), and a replay runs no Python."""
    for name, n in delta.items():
        LAUNCHES[name] += n


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built at first use "
            "and need the CUDA toolkit"
        )
    return path


def _digest(paths: Sequence[Path], flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def compile_library(
    name: str, sources: Sequence[Path], cmd_prefix: List[str],
    flags: Sequence[str],
) -> Path:
    """Compile `sources` into `_build/lib<name>-<hash>.so` unless it is
    there already; returns the library's path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}-{_digest(sources, flags)}.so"
    if out.exists():
        build_seconds.setdefault(name, 0.0)
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [*cmd_prefix, *flags, "-o", str(tmp), *map(str, sources)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {name} failed:\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    return out


def load_cuda_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """nvcc-build `csrc/<sources>` for sm_90a (once) and dlopen it. Builds
    of different libraries may run at once."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is None:
            paths = [CSRC_DIR / s for s in sources]
            lib = ctypes.CDLL(
                str(compile_library(name, paths, [_nvcc()], NVCC_FLAGS))
            )
            _libs[name] = lib
        return lib


def build_parallel(loaders: Sequence[Callable[[], object]]) -> None:
    """Call every loader at once, each in its own thread (one compiler
    process each), and raise the first failure."""
    with ThreadPoolExecutor(max_workers=max(1, len(loaders))) as pool:
        for future in [pool.submit(fn) for fn in loaders]:
            future.result()
