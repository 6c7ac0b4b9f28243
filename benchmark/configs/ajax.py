"""The ajax composition: the camera of Nori's pa2/pa5 ajax scenes around
a 541,660-triangle displaced-ellipsoid stand-in for the absent scan,
lit by one emissive quad (frozen copy of the port's
`scenes_builtin.ajax_standin_meshdata` and `bench.ajax_scene`)."""

from __future__ import annotations

import numpy as np

from benchmark.scenegen import (
    BLACK, CameraDesc, MeshDesc, SceneDesc, microfacet, quad)


def standin(cfg: dict):
    """(positions, faces) of the stand-in bust."""
    n_lat, n_lon = int(cfg["n_lat"]), int(cfg["n_lon"])
    rng = np.random.RandomState(int(cfg["standin_seed"]))
    origin = np.asarray(cfg["origin"], np.float64)
    d = np.asarray(cfg["target"], np.float64) - origin
    d /= np.linalg.norm(d)
    center = origin + 26.0 * d
    center[1] = 26.0
    radius = 11.0
    y_stretch = 2.1
    theta = np.linspace(1e-3, np.pi - 1e-3, n_lat)
    phi = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    disp = np.zeros_like(tt)
    for k, (ft, fp) in enumerate([(3, 5), (7, 4), (13, 11), (24, 19)]):
        a = 1.6 / (k + 1) ** 1.1
        ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
        disp += a * np.abs(np.sin(ft * tt + ph1) * np.cos(fp * pp + ph2))
    r = radius + disp - disp.mean()
    x = r * np.sin(tt) * np.cos(pp)
    y = r * np.cos(tt) * y_stretch
    z = r * np.sin(tt) * np.sin(pp)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3) + center
    i = np.arange(n_lat - 1)[:, None]
    j = np.arange(n_lon)[None, :]
    jn = (j + 1) % n_lon
    v00 = i * n_lon + j
    v01 = i * n_lon + jn
    v10 = (i + 1) * n_lon + j
    v11 = (i + 1) * n_lon + jn
    f1 = np.stack([v00, v11, v10], axis=-1).reshape(-1, 3)
    f2 = np.stack([v00, v01, v11], axis=-1).reshape(-1, 3)
    faces = np.concatenate([f1, f2]).astype(np.uint32)
    return pos.astype(np.float32), faces


def build(cfg: dict) -> SceneDesc:
    pos, faces = standin(cfg)
    meshes = [
        MeshDesc("ajax", pos, faces, microfacet(0.2, [0.3, 0.3, 0.3])),
        MeshDesc("light", *quad(*cfg["light"]), BLACK, None,
                 list(cfg["light_radiance"])),
    ]
    cam = CameraDesc(int(cfg["width"]), int(cfg["height"]), cfg["fov"],
                     cfg["origin"], cfg["target"], cfg["up"])
    return SceneDesc(meshes, cam)
