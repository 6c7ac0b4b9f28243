"""The Cornell box: diffuse walls, a mirror and a glass sphere, a
microfacet panel and one area light (frozen copy of the port's
`scenes_builtin.cornell_box`)."""

from __future__ import annotations

from benchmark.scenegen import (
    BLACK, MIRROR, CameraDesc, MeshDesc, SceneDesc, dielectric, diffuse,
    icosphere, microfacet, quad)


def build(cfg: dict) -> SceneDesc:
    white = diffuse([0.725, 0.71, 0.68])
    red = diffuse([0.63, 0.065, 0.05])
    green = diffuse([0.14, 0.45, 0.091])
    sub = int(cfg["sphere_subdiv"])
    meshes = [
        MeshDesc("floor", *quad([-1, 0, -1], [-1, 0, 1], [1, 0, 1],
                                [1, 0, -1]), white),
        MeshDesc("ceiling", *quad([-1, 2, -1], [1, 2, -1], [1, 2, 1],
                                  [-1, 2, 1]), white),
        MeshDesc("back", *quad([-1, 0, -1], [1, 0, -1], [1, 2, -1],
                               [-1, 2, -1]), white),
        MeshDesc("left", *quad([-1, 0, 1], [-1, 0, -1], [-1, 2, -1],
                               [-1, 2, 1]), red),
        MeshDesc("right", *quad([1, 0, -1], [1, 0, 1], [1, 2, 1],
                                [1, 2, -1]), green),
        MeshDesc("panel", *quad([-0.6, 0.0, -0.999], [0.6, 0.0, -0.999],
                                [0.6, 0.8, -0.999], [-0.6, 0.8, -0.999]),
                 microfacet(0.2, [0.3, 0.3, 0.25])),
    ]
    pos, fcs, nrm = icosphere([-0.45, 0.35, 0.1], 0.35, sub)
    meshes.append(MeshDesc("mirror_sphere", pos, fcs, MIRROR, nrm))
    pos, fcs, nrm = icosphere([0.45, 0.35, 0.35], 0.35, sub)
    meshes.append(MeshDesc("glass_sphere", pos, fcs, dielectric(), nrm))
    meshes.append(MeshDesc(
        "light", *quad([-0.3, 1.999, -0.3], [0.3, 1.999, -0.3],
                       [0.3, 1.999, 0.3], [-0.3, 1.999, 0.3]),
        BLACK, None, [17.0, 12.0, 4.0]))
    cam = CameraDesc(int(cfg["width"]), int(cfg["height"]), cfg["fov"],
                     cfg["origin"], cfg["target"], cfg["up"])
    return SceneDesc(meshes, cam)
