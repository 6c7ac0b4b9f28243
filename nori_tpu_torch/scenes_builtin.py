"""Procedurally built scenes (no external assets).

Used by bench.py, __graft_entry__.py and tests: a Cornell-box-style
scene exercising every BSDF family, built directly as MeshData so no
file IO or reference checkout is required.
"""

from __future__ import annotations

import numpy as np

from nori_tpu_torch.props import PropertyList
from nori_tpu_torch.registry import create_instance
from nori_tpu_torch.obj_loader import MeshData
from nori_tpu_torch.mesh import Mesh


def _quad(p0, p1, p2, p3):
    """Two triangles (p0,p1,p2) + (p0,p2,p3)."""
    verts = np.asarray([p0, p1, p2, p3], dtype=np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], dtype=np.uint32)
    return verts, faces


def _icosphere(center, radius, subdiv=2):
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    for _ in range(subdiv):
        mid = {}
        new_faces = []
        verts = list(map(tuple, verts))

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                v = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0
                v /= np.linalg.norm(v)
                mid[key] = len(verts)
                verts.append(tuple(v))
            return mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        faces = np.asarray(new_faces, dtype=np.int64)
        verts = np.asarray(verts, dtype=np.float64)
    verts = np.asarray(verts, dtype=np.float64)
    pos = (verts * radius + np.asarray(center)).astype(np.float32)
    normals = verts.astype(np.float32)
    return pos, faces.astype(np.uint32), normals


def _mesh_obj(positions, faces, bsdf=None, emitter=None, normals=None,
              name="builtin"):
    m = Mesh()
    m.data = MeshData(
        positions=np.asarray(positions, np.float32),
        normals=None if normals is None else np.asarray(normals, np.float32),
        texcoords=None,
        faces=np.asarray(faces, np.uint32),
        name=name,
    )
    if bsdf is not None:
        m.add_child(bsdf)
    if emitter is not None:
        m.add_child(emitter)
    m.activate()
    return m


def _bsdf(kind, **kw):
    pl = PropertyList()
    for k, v in kw.items():
        if isinstance(v, float):
            pl.set_float(k, v)
        else:
            pl.set_color(k, v)
    return create_instance(kind, pl)


def _area_light(radiance):
    pl = PropertyList()
    pl.set_color("radiance", radiance)
    return create_instance("area", pl)


def _box(center, half, rot_y=0.0):
    """12-triangle box with outward normals, optional y rotation."""
    cx, cy, cz = center
    hx, hy, hz = half
    corners = np.array([
        [sx * hx, sy * hy, sz * hz]
        for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)
    ], dtype=np.float32)
    if rot_y:
        c, s = np.cos(rot_y), np.sin(rot_y)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        corners = corners @ rot.T
    corners += np.asarray(center, np.float32)
    # faces as outward-wound quads over corner indices
    quads = [
        (0, 1, 3, 2),  # -x
        (6, 7, 5, 4),  # +x
        (0, 4, 5, 1),  # -y
        (2, 3, 7, 6),  # +y
        (0, 2, 6, 4),  # -z
        (1, 5, 7, 3),  # +z
    ]
    faces = []
    for a, b, c2, d in quads:
        faces += [[a, b, c2], [a, c2, d]]
    return corners, np.asarray(faces, np.uint32)


def living_room(width: int = 256, height: int = 256, spp: int = 16,
                integrator: str = "path_mis", detail: int = 3):
    """A living-room-class workload (BASELINE.md names the pa5
    living-room scene, which is absent from the reference checkout —
    this is the in-framework reconstruction): a furnished room with
    diffuse walls, glossy floor, sofa, coffee table, mirror ball,
    glass ornament and two area lights.  `detail` controls sphere
    subdivision (3 -> ~25k triangles, 4 -> ~90k)."""
    from nori_tpu_torch.scene import Scene
    from nori_tpu_torch.core.transform import Transform

    scene = Scene(PropertyList())
    meshes = []

    def add(v, f, bsdf=None, emitter=None, normals=None, name="m"):
        meshes.append(_mesh_obj(v, f, bsdf, emitter, normals, name))

    # room shell 6 x 3 x 4.4 (interior-facing)
    W, H, D = 3.0, 3.0, 2.2
    v, f = _quad([-W, 0, -D], [-W, 0, D], [W, 0, D], [W, 0, -D])
    add(v, f, _bsdf("microfacet", alpha=0.08, kd=[0.35, 0.30, 0.25]),
        name="floor")
    v, f = _quad([-W, H, -D], [W, H, -D], [W, H, D], [-W, H, D])
    add(v, f, _bsdf("diffuse", albedo=[0.8, 0.8, 0.8]), name="ceiling")
    v, f = _quad([-W, 0, -D], [W, 0, -D], [W, H, -D], [-W, H, -D])
    add(v, f, _bsdf("diffuse", albedo=[0.65, 0.62, 0.55]), name="back")
    v, f = _quad([-W, 0, D], [-W, 0, -D], [-W, H, -D], [-W, H, D])
    add(v, f, _bsdf("diffuse", albedo=[0.55, 0.35, 0.25]), name="left")
    v, f = _quad([W, 0, -D], [W, 0, D], [W, H, D], [W, H, -D])
    add(v, f, _bsdf("diffuse", albedo=[0.4, 0.45, 0.5]), name="right")

    gray = lambda g: _bsdf("diffuse", albedo=[g, g * 0.95, g * 0.9])
    # sofa: seat + back + armrests
    add(*_box([-1.4, 0.35, -1.2], [1.0, 0.35, 0.55]), gray(0.45),
        name="sofa_seat")
    add(*_box([-1.4, 1.0, -1.68], [1.0, 0.45, 0.12]), gray(0.42),
        name="sofa_back")
    add(*_box([-2.35, 0.75, -1.2], [0.12, 0.35, 0.55]), gray(0.40),
        name="sofa_arm_l")
    add(*_box([-0.45, 0.75, -1.2], [0.12, 0.35, 0.55]), gray(0.40),
        name="sofa_arm_r")
    # coffee table: top + 4 legs
    add(*_box([0.2, 0.58, 0.3], [0.55, 0.04, 0.4], rot_y=0.3),
        _bsdf("microfacet", alpha=0.15, kd=[0.25, 0.15, 0.08]),
        name="table_top")
    for dx in (-0.45, 0.45):
        for dz in (-0.3, 0.3):
            add(*_box([0.2 + dx, 0.27, 0.3 + dz], [0.04, 0.27, 0.04],
                      rot_y=0.3), gray(0.2), name="leg")
    # shelf
    add(*_box([2.7, 1.1, -1.0], [0.25, 1.1, 0.7]), gray(0.5), name="shelf")

    # decorative spheres: mirror ball, glass ornament, diffuse vases
    pos, fcs, nrm = _icosphere([1.6, 0.45, 1.2], 0.45, detail)
    add(pos, fcs, _bsdf("mirror"), normals=nrm, name="mirror_ball")
    pos, fcs, nrm = _icosphere([0.2, 0.75, 0.3], 0.13, detail)
    add(pos, fcs, _bsdf("dielectric"), normals=nrm, name="glass_ornament")
    pos, fcs, nrm = _icosphere([2.7, 2.35, -1.0], 0.15, detail - 1)
    add(pos, fcs, _bsdf("diffuse", albedo=[0.6, 0.2, 0.15]), normals=nrm,
        name="vase")
    pos, fcs, nrm = _icosphere([-1.4, 0.82, -1.2], 0.12, detail - 1)
    add(pos, fcs, _bsdf("diffuse", albedo=[0.7, 0.6, 0.2]), normals=nrm,
        name="cushion_ball")

    # lights: ceiling panel + warm floor lamp
    v, f = _quad([-0.5, 2.995, -0.4], [0.5, 2.995, -0.4],
                 [0.5, 2.995, 0.4], [-0.5, 2.995, 0.4])
    add(v, f, _bsdf("diffuse", albedo=[0, 0, 0]),
        emitter=_area_light([38.0, 34.0, 26.0]), name="panel_light")
    pos, fcs, nrm = _icosphere([2.3, 1.9, 1.5], 0.12, 2)
    add(pos, fcs, _bsdf("diffuse", albedo=[0, 0, 0]),
        emitter=_area_light([40.0, 24.0, 8.0]), normals=nrm, name="lamp")

    for m in meshes:
        scene.add_child(m)

    cam_pl = PropertyList()
    cam_pl.set_integer("width", width)
    cam_pl.set_integer("height", height)
    cam_pl.set_float("fov", 55.0)
    cam_pl.set_transform(
        "toWorld",
        Transform.lookat([0.3, 1.5, 2.05], [-0.3, 0.9, -1.0], [0, 1, 0]),
    )
    cam = create_instance("perspective", cam_pl)
    cam.activate()
    scene.add_child(cam)
    samp_pl = PropertyList()
    samp_pl.set_integer("sampleCount", spp)
    scene.add_child(create_instance("independent", samp_pl))
    scene.add_child(create_instance(integrator, PropertyList()))
    scene.activate()
    return scene


def cornell_box(width: int = 512, height: int = 512, spp: int = 16,
                integrator: str = "path_mis", sphere_subdiv: int = 3):
    """A self-contained Cornell box: diffuse walls, mirror + dielectric
    spheres, microfacet floor patch, area light."""
    from nori_tpu_torch.scene import Scene
    from nori_tpu_torch.core.transform import Transform

    scene = Scene(PropertyList())

    white = _bsdf("diffuse", albedo=[0.725, 0.71, 0.68])
    red = _bsdf("diffuse", albedo=[0.63, 0.065, 0.05])
    green = _bsdf("diffuse", albedo=[0.14, 0.45, 0.091])

    # box interior: y up, open toward +z camera; interior-facing windings
    meshes = []
    v, f = _quad([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1])  # floor +y
    meshes.append(_mesh_obj(v, f, white, name="floor"))
    v, f = _quad([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1])  # ceiling -y
    meshes.append(_mesh_obj(v, f, white, name="ceiling"))
    v, f = _quad([-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1])  # back +z
    meshes.append(_mesh_obj(v, f, white, name="back"))
    v, f = _quad([-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1])  # left +x
    meshes.append(_mesh_obj(v, f, red, name="left"))
    v, f = _quad([1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1])  # right -x
    meshes.append(_mesh_obj(v, f, green, name="right"))

    # microfacet panel on the back wall (+z facing)
    v, f = _quad([-0.6, 0.0, -0.999], [0.6, 0.0, -0.999],
                 [0.6, 0.8, -0.999], [-0.6, 0.8, -0.999])
    meshes.append(_mesh_obj(
        v, f, _bsdf("microfacet", alpha=0.2, kd=[0.3, 0.3, 0.25]),
        name="panel"))

    # spheres: mirror and glass
    pos, fcs, nrm = _icosphere([-0.45, 0.35, 0.1], 0.35, sphere_subdiv)
    meshes.append(_mesh_obj(pos, fcs, _bsdf("mirror"), normals=nrm,
                            name="mirror_sphere"))
    pos, fcs, nrm = _icosphere([0.45, 0.35, 0.35], 0.35, sphere_subdiv)
    meshes.append(_mesh_obj(pos, fcs, _bsdf("dielectric"), normals=nrm,
                            name="glass_sphere"))

    # area light just below the ceiling (-y facing)
    v, f = _quad([-0.3, 1.999, -0.3], [0.3, 1.999, -0.3],
                 [0.3, 1.999, 0.3], [-0.3, 1.999, 0.3])
    meshes.append(_mesh_obj(
        v, f, _bsdf("diffuse", albedo=[0.0, 0.0, 0.0]),
        emitter=_area_light([17.0, 12.0, 4.0]), name="light"))

    for m in meshes:
        scene.add_child(m)

    cam_pl = PropertyList()
    cam_pl.set_integer("width", width)
    cam_pl.set_integer("height", height)
    cam_pl.set_float("fov", 40.0)
    cam_pl.set_transform(
        "toWorld", Transform.lookat([0, 1.0, 3.9], [0, 1.0, 0], [0, 1, 0])
    )
    cam = create_instance("perspective", cam_pl)
    cam.activate()
    scene.add_child(cam)

    samp_pl = PropertyList()
    samp_pl.set_integer("sampleCount", spp)
    scene.add_child(create_instance("independent", samp_pl))

    scene.add_child(create_instance(integrator, PropertyList()))
    scene.activate()
    return scene


def ajax_standin_meshdata(n_lat: int = 512, n_lon: int = 530,
                         seed: int = 7):
    """Procedural ~544k-triangle stand-in for the absent ajax.obj scan.

    The reference's pa2/pa3/pa5 ajax scenes reference a ~544k-triangle
    bust scan from the Jotero forum that is NOT shipped in the checkout
    (scenes/ carries only the XMLs and light.obj).  This builds a
    displaced sphere with the same triangle count, positioned to fill
    the same 30-degree camera frustum (origin -65.6, 47.6, 24.4 looking
    at -64.8, 47.2, 23.9, scenes/pa2/ajax-normals.xml:20-24) and to
    face the pa5 area light (scenes/pa5/ajax/light.obj) — a comparable
    intersection workload with non-trivial spatial structure for the
    streamed sweep.
    """
    from nori_tpu_torch.obj_loader import MeshData

    rng = np.random.RandomState(seed)
    # camera geometry from the ajax XMLs
    origin = np.array([-65.6055, 47.5762, 24.3583])
    target = np.array([-64.8161, 47.2211, 23.8576])
    d = target - origin
    d /= np.linalg.norm(d)
    # bust-like ellipsoid: tall in y, reaching down past the pa5 area
    # light's span (y 6.3..33.7, scenes/pa5/ajax/light.obj) so the
    # whitted/microfacet scenes are actually lit
    center = origin + 26.0 * d
    center[1] = 26.0
    radius = 11.0
    y_stretch = 2.1

    theta = np.linspace(1e-3, np.pi - 1e-3, n_lat)
    phi = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    # ridged multi-frequency displacement (scan-like surface detail)
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

    # grid faces with longitudinal wraparound
    i = np.arange(n_lat - 1)[:, None]
    j = np.arange(n_lon)[None, :]
    jn = (j + 1) % n_lon
    v00 = i * n_lon + j
    v01 = i * n_lon + jn
    v10 = (i + 1) * n_lon + j
    v11 = (i + 1) * n_lon + jn
    # wound so geometric normals point OUTWARD (the default-shading
    # normals and every BSDF hemisphere check depend on it)
    f1 = np.stack([v00, v11, v10], axis=-1).reshape(-1, 3)
    f2 = np.stack([v00, v01, v11], axis=-1).reshape(-1, 3)
    faces = np.concatenate([f1, f2]).astype(np.uint32)
    return MeshData(
        positions=pos.astype(np.float32), normals=None, texcoords=None,
        faces=faces, name="ajax-standin")
