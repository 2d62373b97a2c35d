"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every kernel is one source, ``kernels/<name>/csrc/<name>.cu``, with a plain
C interface (no PyTorch headers, so a build takes seconds).  ``load(name)``
compiles it at first use for Hopper (``sm_90a``) into
``<checkout>/build/repro_torch/<name>-<hash>.so``, where the hash covers the
source and the compiler flags, and loads the shared library.  ``build()``
starts one ``nvcc`` per source, all at once, and waits for them.  The
compiler's report (``-Xptxas -v``: registers, shared memory, spills) is
kept beside each library as ``<name>-<hash>.log``.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

KERNELS = ("cgemm", "dft_tile")

_KERNELS_DIR = pathlib.Path(__file__).resolve().parent
# src/repro_torch/kernels -> the checkout root (listed in .gitignore)
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}                       # name -> loaded ctypes.CDLL


def source(name: str) -> pathlib.Path:
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; known: {KERNELS}")
    return _KERNELS_DIR / name / "csrc" / f"{name}.cu"


def library(name: str) -> pathlib.Path:
    """Path of the built library for the current source and flags."""
    digest = hashlib.sha256(source(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on the PATH): the "
        "port's CUDA kernels are built from source at first use")


def build(names=KERNELS) -> dict:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns ``{name: library path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
        jobs.append((name, out, tmp, log,
                     subprocess.Popen(cmd, stdout=log,
                                      stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          + out.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return {name: library(name) for name in names}


def build_log(name: str) -> str:
    """The compiler's report for the current build of ``name``."""
    return library(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed, loaded once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build((name,))[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
