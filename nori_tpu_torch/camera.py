"""Cameras.

Port of `nori_tpu/camera.py`: PerspectiveCamera is a behavioural port
of src/perspective.cpp:32-150.  The sample->camera projective transform
is built in activate() with the same matrix chain, and `sample_rays`
generates a whole wavefront of primary rays at once.
"""

from __future__ import annotations

import torch

from nori_tpu_torch import registry
from nori_tpu_torch.objects import NoriObject
from nori_tpu_torch.props import PropertyList
from nori_tpu_torch.registry import register_class, NoriError, create_instance
from nori_tpu_torch.core.transform import Transform


class Camera(NoriObject):
    class_kind = registry.CAMERA
    output_size = (0, 0)  # (width, height)
    rfilter = None


@register_class("perspective")
class PerspectiveCamera(Camera):
    def __init__(self, props: PropertyList):
        self.width = props.get_integer("width", 1280)
        self.height = props.get_integer("height", 720)
        self.output_size = (self.width, self.height)
        self.camera_to_world = props.get_transform("toWorld", Transform())
        self.fov = props.get_float("fov", 30.0)
        self.near_clip = props.get_float("nearClip", 1e-4)
        self.far_clip = props.get_float("farClip", 1e4)
        self.rfilter = None
        self.sample_to_camera = None

    def activate(self):
        aspect = self.width / float(self.height)
        # matrix chain identical to src/perspective.cpp:60-80
        persp = Transform.perspective(self.fov, self.near_clip, self.far_clip)
        scale = Transform.scale([-0.5, -0.5 * aspect, 1.0])
        translate = Transform.translate([-1.0, -1.0 / aspect, 0.0])
        self.sample_to_camera = (scale * translate * persp).inverse()
        if self.rfilter is None:
            self.rfilter = create_instance("gaussian", PropertyList())

    def add_child(self, child):
        if child.class_kind == registry.RFILTER:
            if self.rfilter is not None:
                raise NoriError("Camera: multiple reconstruction filters!")
            self.rfilter = child
        else:
            super().add_child(child)

    def ray_params(self, device) -> dict:
        """float32 tensors on `device` consumed by sample_rays."""
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        return {
            "sample_to_camera": f32(self.sample_to_camera.m),
            "camera_to_world": f32(self.camera_to_world.m),
            "inv_output_size": f32([1.0 / self.width, 1.0 / self.height]),
            "near_clip": f32(self.near_clip),
            "far_clip": f32(self.far_clip),
        }

    @staticmethod
    def sample_rays(params, sample_positions):
        """Batched primary ray generation (port of sampleRay,
        src/perspective.cpp:88-109).

        sample_positions: (N, 2) continuous pixel coordinates.
        Returns (o, d, mint, maxt): (N,3),(N,3),(N,),(N,).
        """
        s2c = params["sample_to_camera"]
        c2w = params["camera_to_world"]
        p = sample_positions * params["inv_output_size"]
        # the 4x4 applications are elementwise broadcast sums, as in the
        # JAX package, so the rounding matches it
        xyz0 = torch.stack(
            [p[..., 0], p[..., 1], torch.zeros_like(p[..., 0])], dim=-1)

        def apply_rows(m3, v):
            return (m3[:, 0] * v[..., 0:1] + m3[:, 1] * v[..., 1:2]
                    + m3[:, 2] * v[..., 2:3])

        near_p = apply_rows(s2c[:3, :3], xyz0) + s2c[:3, 3]
        w = (s2c[3, 0] * xyz0[..., 0] + s2c[3, 1] * xyz0[..., 1]
             + s2c[3, 2] * xyz0[..., 2] + s2c[3, 3])
        near_p = near_p / w[..., None]

        d_cam = near_p / torch.sqrt(
            torch.sum(near_p * near_p, dim=-1, keepdim=True))
        inv_z = 1.0 / d_cam[..., 2]

        o_world = torch.broadcast_to(c2w[:3, 3], d_cam.shape)
        d_world = apply_rows(c2w[:3, :3], d_cam)
        # unit-length contract: slab entry bounds and NEE distances
        # assume |d| == 1
        d_world = d_world / torch.sqrt(
            torch.sum(d_world * d_world, dim=-1, keepdim=True))
        mint = params["near_clip"] * inv_z
        maxt = params["far_clip"] * inv_z
        return o_world, d_world, mint, maxt

    def to_string(self):
        return (
            f"PerspectiveCamera[size={self.width}x{self.height}, "
            f"fov={self.fov}, clip=[{self.near_clip}, {self.far_clip}]]"
        )
