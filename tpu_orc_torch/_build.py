"""Build the port's CUDA kernels with ``nvcc`` at first use; load them with
ctypes.

Each source ``csrc/<name>.cu`` has a plain C entry point and is compiled
on its own into ``build/tpu_orc_torch/lib<name>-<hash>.so`` under the
checkout root, keyed on a hash of the source and the flags, through a
per-process temporary name and an atomic rename (the scheme of
``tpu_orc/native/__init__.py:_build``). Nothing here runs at import time:
the CPU tests import every module of the port on hosts without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tpu_orc_torch")
SOURCES = ("locate", "myers", "pileup", "viterbi", "batched", "pack",
           "emit")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas register/spill report of each build, for the smoke log
PTXAS_LOG: Dict[str, str] = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or
    ``nvcc`` on PATH. Raises when there is none."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of tpu_orc_torch "
                       "are built at first use on a host with the CUDA "
                       "toolkit")


def so_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as fh:
        h = hashlib.sha256(fh.read() + " ".join(FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{h[:16]}.so")


def _start(name: str):
    out = so_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    try:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
        PTXAS_LOG[name] = log
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together. Returns the wall seconds of the whole build."""
    t0 = time.perf_counter()
    with _lock:
        started = [(n, _start(n)) for n in names]
        for n, s in started:
            _finish(n, s)
    return {"build_s": time.perf_counter() - t0}


def load(name: str, symbol: str, argtypes) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if needed) with
    ``symbol``'s argument types declared; its return type is int, the
    ``cudaError_t`` of the launch. A library may hold several entry
    points: each (library, symbol) pair gets a handle of its own."""
    key = f"{name}:{symbol}"
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(so_path(name))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _libs[key] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


class LaunchCounter:
    """Thread-safe launch counts of one kernel, keyed by entry point or
    mode, in total and per device. A wrapper adds one where it launches
    its kernel and nowhere else; ``run_all``'s bin workers launch from
    several threads, the multi-device path onto several cards."""

    def __init__(self, keys: Sequence[str]):
        self._lock = threading.Lock()
        self._n = {k: 0 for k in keys}
        self._per_dev: Dict[str, Dict[str, int]] = {}

    def add(self, key: str, device) -> None:
        """One launch of ``key`` onto ``device`` (a torch.device)."""
        with self._lock:
            self._n[key] += 1
            per = self._per_dev.setdefault(str(device), {})
            per[key] = per.get(key, 0) + 1

    def reset(self) -> None:
        with self._lock:
            for k in self._n:
                self._n[k] = 0
            self._per_dev.clear()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._n)

    def by_device(self) -> Dict[str, Dict[str, int]]:
        """{device: {key: launches}} since the last reset."""
        with self._lock:
            return {d: dict(n) for d, n in self._per_dev.items()}
