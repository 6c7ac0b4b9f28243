"""The living room: a furnished room with diffuse walls, a glossy floor,
a mirror ball, a glass ornament and two area lights (frozen copy of the
port's `scenes_builtin.living_room`)."""

from __future__ import annotations

from benchmark.scenegen import (
    BLACK, MIRROR, CameraDesc, MeshDesc, SceneDesc, box, dielectric,
    diffuse, icosphere, microfacet, quad)


def build(cfg: dict) -> SceneDesc:
    meshes = []

    def add(v, f, bsdf, emitter=None, normals=None, name="m"):
        meshes.append(MeshDesc(name, v, f, bsdf, normals, emitter))

    detail = int(cfg["detail"])
    W, H, D = 3.0, 3.0, 2.2
    add(*quad([-W, 0, -D], [-W, 0, D], [W, 0, D], [W, 0, -D]),
        microfacet(0.08, [0.35, 0.30, 0.25]), name="floor")
    add(*quad([-W, H, -D], [W, H, -D], [W, H, D], [-W, H, D]),
        diffuse([0.8, 0.8, 0.8]), name="ceiling")
    add(*quad([-W, 0, -D], [W, 0, -D], [W, H, -D], [-W, H, -D]),
        diffuse([0.65, 0.62, 0.55]), name="back")
    add(*quad([-W, 0, D], [-W, 0, -D], [-W, H, -D], [-W, H, D]),
        diffuse([0.55, 0.35, 0.25]), name="left")
    add(*quad([W, 0, -D], [W, 0, D], [W, H, D], [W, H, -D]),
        diffuse([0.4, 0.45, 0.5]), name="right")

    def gray(g):
        return diffuse([g, g * 0.95, g * 0.9])

    add(*box([-1.4, 0.35, -1.2], [1.0, 0.35, 0.55]), gray(0.45),
        name="sofa_seat")
    add(*box([-1.4, 1.0, -1.68], [1.0, 0.45, 0.12]), gray(0.42),
        name="sofa_back")
    add(*box([-2.35, 0.75, -1.2], [0.12, 0.35, 0.55]), gray(0.40),
        name="sofa_arm_l")
    add(*box([-0.45, 0.75, -1.2], [0.12, 0.35, 0.55]), gray(0.40),
        name="sofa_arm_r")
    add(*box([0.2, 0.58, 0.3], [0.55, 0.04, 0.4], rot_y=0.3),
        microfacet(0.15, [0.25, 0.15, 0.08]), name="table_top")
    for dx in (-0.45, 0.45):
        for dz in (-0.3, 0.3):
            add(*box([0.2 + dx, 0.27, 0.3 + dz], [0.04, 0.27, 0.04],
                     rot_y=0.3), gray(0.2), name="leg")
    add(*box([2.7, 1.1, -1.0], [0.25, 1.1, 0.7]), gray(0.5), name="shelf")

    pos, fcs, nrm = icosphere([1.6, 0.45, 1.2], 0.45, detail)
    add(pos, fcs, MIRROR, normals=nrm, name="mirror_ball")
    pos, fcs, nrm = icosphere([0.2, 0.75, 0.3], 0.13, detail)
    add(pos, fcs, dielectric(), normals=nrm, name="glass_ornament")
    pos, fcs, nrm = icosphere([2.7, 2.35, -1.0], 0.15, detail - 1)
    add(pos, fcs, diffuse([0.6, 0.2, 0.15]), normals=nrm, name="vase")
    pos, fcs, nrm = icosphere([-1.4, 0.82, -1.2], 0.12, detail - 1)
    add(pos, fcs, diffuse([0.7, 0.6, 0.2]), normals=nrm,
        name="cushion_ball")

    add(*quad([-0.5, 2.995, -0.4], [0.5, 2.995, -0.4],
              [0.5, 2.995, 0.4], [-0.5, 2.995, 0.4]),
        BLACK, emitter=[38.0, 34.0, 26.0], name="panel_light")
    pos, fcs, nrm = icosphere([2.3, 1.9, 1.5], 0.12, 2)
    add(pos, fcs, BLACK, emitter=[40.0, 24.0, 8.0], normals=nrm,
        name="lamp")

    cam = CameraDesc(int(cfg["width"]), int(cfg["height"]), cfg["fov"],
                     cfg["origin"], cfg["target"], cfg["up"])
    return SceneDesc(meshes, cam)
