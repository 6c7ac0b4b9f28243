"""Build and load the port's CUDA kernels.

The sources under `nori_tpu_torch/csrc/` have plain `extern "C"` entry
points.  At first use each `.cu` file is compiled by its own `nvcc`
for Hopper (sm_90a), all at once, and the objects are linked into one
shared library under `nori_tpu_torch/_build/`, named by a hash of the
sources and flags so an edit forces a rebuild, and loaded with
ctypes.  Nothing here runs at import time: the CPU tests import
every module of the port on a machine with no `nvcc`.

Flags: no `--use_fast_math` (the slab and pair tests rely on IEEE
division), and `--fmad=false`, so no multiply-add is contracted and
every kernel rounds exactly as its plain PyTorch version on the card.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
]

_lib = None
#: compiler output of the build this process ran (empty when cached)
build_log = ""


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of nori_tpu_torch "
                       "build only on a machine with the CUDA toolkit")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libnori_sweep_{h.hexdigest()[:16]}.so")


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.entry_min_launch.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.resident_sweep_launch.argtypes = [
        vp, ci, ci, vp, ci, ci, vp, ci, vp, vp, ci, vp, vp, vp, vp, vp, vp,
        vp]
    lib.lane_keys_launch.argtypes = [vp, ci, ci, vp, ci, vp, vp, ci, vp]
    lib.stream_sweep_launch.argtypes = [
        vp, ci, ci, vp, ci, ci, vp, ci, vp, vp, ci, ci, vp, vp, vp, vp, vp,
        vp, vp, vp]
    lib.mt_sweep_launch.argtypes = [
        vp, ci, vp, vp, vp, vp, ci, vp, ci, vp, vp, vp, vp, ci, ci, vp, vp,
        vp, vp, vp, vp]
    for fn in (lib.entry_min_launch, lib.resident_sweep_launch,
               lib.lane_keys_launch, lib.stream_sweep_launch,
               lib.mt_sweep_launch):
        fn.restype = ci


def load():
    """The kernel library, built on first use; raises if the build
    fails."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tag = f"tmp{os.getpid()}"
        cu = [p for p in _sources() if p.endswith(".cu")]
        objs = [os.path.join(BUILD_DIR, os.path.basename(p) + f".{tag}.o")
                for p in cu]
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", o, p],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for p, o in zip(cu, objs)]
        logs, failed = [], False
        for proc in procs:
            out, _ = proc.communicate(timeout=900)
            logs.append(out)
            failed |= proc.returncode != 0
        if not failed:
            tmp = f"{path}.{tag}"
            proc = subprocess.run(
                [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-shared", "-o", tmp, *objs],
                capture_output=True, text=True, timeout=300)
            logs.append(proc.stdout + proc.stderr)
            failed = proc.returncode != 0
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    _declare(lib)
    _lib = lib
    return lib
