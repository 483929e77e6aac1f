"""Build and load the package's CUDA sources.

Each ``tpusparse_torch/csrc/<name>.cu`` has a plain C interface (the
machinery the sources share is in the ``csrc/*.cuh`` headers) and is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``tpusparse_torch/_build/`` at first use, then loaded with ``ctypes``.  The
library's file name carries a hash of the source and the flags, so a stale
build is never loaded and processes that build at once do not collide.
A missing ``nvcc`` or a failed build raises; nothing falls back.

The host helpers (``csrc/tpusparse_host.cpp``, ``tpusparse_torch/native.py``)
are built the same way by ``g++`` (or ``$CXX``): ``host_library``.
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

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("dg_gather", "dgt_gather", "tile_onehot", "span_gather", "radix_gather",
           "stripe_gather", "nm_structured", "block_ell", "sddmm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_SOURCE = "tpusparse_host"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: per source: {"seconds": build time (0.0 when a finished build was found),
#: "log": nvcc's output with the -Xptxas -v register/shared/spill lines}
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of the source, the headers it
    may include (every ``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every source in ``names`` that has no finished build, all
    ``nvcc`` processes started together; returns ``build_info``."""
    with _lock:
        todo = [n for n in names if not _lib_path(n).exists()]
        for n in names:
            if n not in todo:
                build_info.setdefault(n, {"seconds": 0.0, "log": "(found a finished build)"})
        if not todo:
            return build_info
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), tmp)
        failed = []
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            build_info[n] = {"seconds": time.perf_counter() - t0, "log": log}
            if proc.returncode:
                failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _lib_path(n))
        if failed:
            raise RuntimeError("CUDA build failed: " + "\n".join(failed))
        return build_info


def library_path(name: str) -> Path:
    """The built shared library of ``csrc/<name>.cu`` (built on first use)."""
    library(name)
    return _lib_path(name)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def cxx_path() -> str:
    """The host compiler: ``$CXX`` where set, else ``g++`` on the PATH."""
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if not found:
        raise RuntimeError(f"host compiler {cxx!r} not found (set CXX or put g++ on PATH): "
                           "the host helpers are built from source at first use")
    return found


def host_library() -> ctypes.CDLL:
    """The loaded host helper library (``csrc/tpusparse_host.cpp``), built by
    the host compiler at first use into ``_build/`` under a name hashed from
    the source, the compiler and the flags; written to a temporary file and
    renamed, so processes that build it at once do not collide.  A missing
    compiler or a failed build raises."""
    with _lock:
        lib = _libs.get(HOST_SOURCE)
        if lib is not None:
            return lib
        cxx = cxx_path()
        src_path = CSRC / f"{HOST_SOURCE}.cpp"
        digest = hashlib.sha256(src_path.read_bytes() + " ".join((cxx, *CXX_FLAGS)).encode())
        path = BUILD_DIR / f"lib{HOST_SOURCE}-{digest.hexdigest()[:12]}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src_path)],
                                  capture_output=True, text=True)
            build_info[HOST_SOURCE] = {"seconds": time.perf_counter() - t0,
                                       "log": proc.stdout + proc.stderr}
            if proc.returncode:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"host build failed ({cxx} exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        lib = _libs[HOST_SOURCE] = ctypes.CDLL(str(path))
        return lib
