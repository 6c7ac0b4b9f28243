"""ctypes bindings for the framework-free native runtime.

The C++ source is the port's own copy, `nori_tpu_torch/csrc/
nori_native.cpp`, byte for byte the JAX package's
`nori_tpu/native/nori_native.cpp` (a test pins the two together).
It is compiled with g++ on first use into `nori_tpu_torch/_build/`
under a filename that embeds the source's content hash, so a stale
binary is never loaded.  The fallback rule is the JAX package's: if
the source is missing or the build fails, every entry point returns
None and callers take their pure-Python path.  This is the host BVH
builder's fallback, not a device one: the BVH order, and so every
triangle index, depends on which builder ran, so both packages must
agree on whether the native path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "nori_native.cpp")
_BUILD = os.path.join(_HERE, "_build")

_lib = None
_tried = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD, f"_nori_native_{digest}.so")


class _ObjResult(ctypes.Structure):
    _fields_ = [
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("faces", ctypes.POINTER(ctypes.c_uint32)),
        ("nv", ctypes.c_int64),
        ("nf", ctypes.c_int64),
        ("has_normals", ctypes.c_int32),
        ("has_uvs", ctypes.c_int32),
        ("error", ctypes.c_char * 256),
    ]


class _BvhResult(ctypes.Structure):
    _fields_ = [
        ("order", ctypes.POINTER(ctypes.c_int32)),
        ("child", ctypes.POINTER(ctypes.c_int32)),
        ("count", ctypes.POINTER(ctypes.c_int32)),
        ("bmin", ctypes.POINTER(ctypes.c_float)),
        ("bmax", ctypes.POINTER(ctypes.c_float)),
        ("n_nodes", ctypes.c_int64),
        ("n_tris", ctypes.c_int64),
    ]


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib_path = _lib_path()
        if not os.path.exists(lib_path):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = lib_path + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.obj_load.restype = ctypes.POINTER(_ObjResult)
        lib.obj_load.argtypes = [ctypes.c_char_p]
        lib.obj_free.argtypes = [ctypes.POINTER(_ObjResult)]
        lib.bvh_build.restype = ctypes.POINTER(_BvhResult)
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        lib.bvh_free.argtypes = [ctypes.POINTER(_BvhResult)]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def obj_load(path: str):
    """Native OBJ parse; returns (positions, normals|None, uvs|None,
    faces) or None if the native library is unavailable/failed."""
    lib = _load()
    if lib is None:
        return None
    res = lib.obj_load(path.encode())
    try:
        r = res.contents
        if r.nv == 0:
            return None
        pos = np.ctypeslib.as_array(r.positions, (r.nv, 3)).copy()
        faces = np.ctypeslib.as_array(r.faces, (r.nf, 3)).copy()
        nrm = (
            np.ctypeslib.as_array(r.normals, (r.nv, 3)).copy()
            if r.has_normals == 1 else None
        )
        uv = (
            np.ctypeslib.as_array(r.uvs, (r.nv, 2)).copy()
            if r.has_uvs == 1 else None
        )
        return pos, nrm, uv, faces
    finally:
        lib.obj_free(res)


def bvh_build(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """Native binned-SAH wide-BVH build; returns (order, child, count,
    bmin, bmax) or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    n = v0.shape[0]
    fp = ctypes.POINTER(ctypes.c_float)
    res = lib.bvh_build(
        v0.ctypes.data_as(fp), e1.ctypes.data_as(fp),
        e2.ctypes.data_as(fp), n,
    )
    try:
        r = res.contents
        order = np.ctypeslib.as_array(r.order, (r.n_tris,)).copy()
        child = np.ctypeslib.as_array(r.child, (r.n_nodes, 8)).copy()
        count = np.ctypeslib.as_array(r.count, (r.n_nodes, 8)).copy()
        bmin = np.ctypeslib.as_array(r.bmin, (r.n_nodes, 8, 3)).copy()
        bmax = np.ctypeslib.as_array(r.bmax, (r.n_nodes, 8, 3)).copy()
        return order, child, count, bmin, bmax
    finally:
        lib.bvh_free(res)
