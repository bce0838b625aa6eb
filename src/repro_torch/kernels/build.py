"""Build the CUDA kernels with nvcc and load them with ctypes.

Each `csrc/*.cu` compiles on its own into a shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so

at first use, into `build/kernels/` at the root of the checkout (listed in
`.gitignore`). The file name carries a hash of the source, the shared
headers (`csrc/*.cuh`) and the flags, so an edited source is rebuilt and
never confused with a stale library. One nvcc process runs per source, all
started together. A build that fails raises with the compiler's output;
nothing falls back.

`library()` loads every library that `build()` compiles and declares the C
entry points of each source from `ENTRY_POINTS` (keyed by the source's
stem); the returned object exposes all of them by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# per source (csrc/<stem>.cu): its C entry points, (argtypes, restype)
ENTRY_POINTS = {
    "kmvm": {
        "kmvm_fwd": ([_I, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                      _I, _P], _I),
        "kmvm_dots_fwd": ([_I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I,
                           _I, _I, _I, _I, _I, _P], _I),
        "kmvm_acc_fwd": ([_I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                          _P], _I),
        "kmvm_error_string": ([_I], ctypes.c_char_p),
    },
    "kgrad": {
        "kgrad_fwd": ([_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                       _P], _I),
        "kgrad_error_string": ([_I], ctypes.c_char_p),
    },
    "kmvm_sparse": {
        "kmvm_bs_fwd": ([_I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                         _I, _I, _I, _I, _I, _P], _I),
        "kmvm_bs_error_string": ([_I], ctypes.c_char_p),
    },
}

_lib = None
_lib_lock = threading.Lock()  # batcher workers may be the first callers


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build(force: bool = False) -> dict:
    """Compile every source under csrc/ (in parallel). Returns
    {"seconds": wall time, "ptxas": the -Xptxas -v lines, "libs": paths}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = _sources()
    jobs = []
    t0 = time.perf_counter()
    for src in sources:
        out = _target(src)
        if out.exists() and not force:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    lines = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        os.replace(tmp, out)
        lines += [ln.strip() for ln in log.splitlines()
                  if "ptxas" in ln or "spill" in ln]
    return {"seconds": time.perf_counter() - t0, "ptxas": lines,
            "libs": [str(_target(s)) for s in sources]}


class _Kernels:
    """The C entry points of every kernel library, as attributes."""

    def __init__(self, fns: dict):
        self.__dict__.update(fns)


def library() -> _Kernels:
    """Every kernel library, built at first use, with the argtypes of each
    source's entry points declared; raises for a source without a
    declaration or a declared entry point its library lacks."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            _lib = _load()
    return _lib


def _load() -> _Kernels:
    sources = _sources()
    if any(not _target(src).exists() for src in sources):
        build()
    fns = {}
    for src in sources:
        if src.stem not in ENTRY_POINTS:
            raise RuntimeError(f"no entry points declared for csrc/{src.name}")
        lib = ctypes.CDLL(str(_target(src)))
        for name, (argtypes, restype) in ENTRY_POINTS[src.stem].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
            fns[name] = fn
    return _Kernels(fns)
