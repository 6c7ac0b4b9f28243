"""The Cornell box with a scanned bust: cbox.py's walls, microfacet
panel, light and camera, with ajax.py's 541,660-triangle stand-in in
place of the two spheres, scaled and moved to stand on the floor at the
box's centre.  The soup is over the port's resident budget, so the
scene takes the streamed layout."""

from __future__ import annotations

import numpy as np

from benchmark.configs import ajax, cbox
from benchmark.scenegen import MeshDesc, SceneDesc, microfacet

#: the meshes of cbox.py's scene that this one keeps
ROOM = ("floor", "ceiling", "back", "left", "right", "panel", "light")


def build(cfg: dict) -> SceneDesc:
    # the spheres cbox.build makes are left out, so their subdivision
    # is the cheapest
    room = cbox.build({**cfg, "sphere_subdiv": 0})
    pos, faces = ajax.standin(cfg)
    pos = (pos.astype(np.float64) * float(cfg["standin_scale"])
           + np.asarray(cfg["standin_offset"], np.float64))
    bust = MeshDesc("ajax", pos.astype(np.float32), faces,
                    microfacet(0.2, [0.3, 0.3, 0.3]))
    meshes = [m for m in room.meshes if m.name in ROOM]
    # the light stays last, as in cbox.py
    meshes.insert(len(meshes) - 1, bust)
    return SceneDesc(meshes, room.camera)
