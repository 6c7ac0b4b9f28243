"""Homogeneous 4x4 transforms carrying their inverse.

Host-side (numpy) replacement for include/nori/transform.h:34-96.  A
Transform is built once during scene parsing and baked into device
arrays, so this stays plain numpy; batched application to device arrays
is provided by `apply_point`/`apply_vector`/`apply_normal` taking the
4x4 matrix as a torch tensor.

Semantics mirror the reference exactly:
  * vectors:  top-left 3x3 * v
  * normals:  transpose(inverse 3x3) * n
  * points:   full projective transform with w-divide
  * rays:     transform o as point, d as vector (ray.h via transform.h:80-95)
"""

from __future__ import annotations

import numpy as np
import torch


class Transform:
    __slots__ = ("m", "inv")

    def __init__(self, m: np.ndarray | None = None, inv: np.ndarray | None = None):
        if m is None:
            m = np.eye(4, dtype=np.float64)
        m = np.asarray(m, dtype=np.float64).reshape(4, 4)
        if inv is None:
            inv = np.linalg.inv(m)
        self.m = m
        self.inv = np.asarray(inv, dtype=np.float64).reshape(4, 4)

    def inverse(self) -> "Transform":
        return Transform(self.inv, self.m)

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.inv @ self.inv)

    def __mul__(self, other):
        return self.__matmul__(other)

    # -- host-side single application (parsing / camera setup) --
    def apply_point(self, p):
        p = np.asarray(p, dtype=np.float64)
        r = self.m @ np.append(p, 1.0)
        return r[:3] / r[3]

    def apply_vector(self, v):
        return self.m[:3, :3] @ np.asarray(v, dtype=np.float64)

    def apply_normal(self, n):
        return self.inv[:3, :3].T @ np.asarray(n, dtype=np.float64)

    def __repr__(self):
        return f"Transform({self.m.tolist()})"

    # -- constructors matching the XML transform ops (src/parser.cpp:255-301) --
    @staticmethod
    def translate(v) -> "Transform":
        m = np.eye(4)
        m[:3, 3] = v
        return Transform(m)

    @staticmethod
    def scale(v) -> "Transform":
        m = np.eye(4)
        m[0, 0], m[1, 1], m[2, 2] = v
        return Transform(m)

    @staticmethod
    def rotate(angle_deg: float, axis) -> "Transform":
        axis = np.asarray(axis, dtype=np.float64)
        axis = axis / np.linalg.norm(axis)
        a = np.deg2rad(angle_deg)
        c, s = np.cos(a), np.sin(a)
        x, y, z = axis
        K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
        R = np.eye(3) * c + s * K + (1 - c) * np.outer(axis, axis)
        m = np.eye(4)
        m[:3, :3] = R
        return Transform(m)

    @staticmethod
    def lookat(origin, target, up) -> "Transform":
        """Camera-to-world from origin/target/up.

        Column layout matches the reference (src/parser.cpp:286-301):
        [left, newUp, dir, origin] with dir = normalize(target-origin),
        left = normalize(normalize(up) x dir), newUp = dir x left.
        """
        origin = np.asarray(origin, dtype=np.float64)
        target = np.asarray(target, dtype=np.float64)
        up = np.asarray(up, dtype=np.float64)
        d = target - origin
        d = d / np.linalg.norm(d)
        left = np.cross(up / np.linalg.norm(up), d)
        left = left / np.linalg.norm(left)
        new_up = np.cross(d, left)
        new_up = new_up / np.linalg.norm(new_up)
        m = np.eye(4)
        m[:3, 0] = left
        m[:3, 1] = new_up
        m[:3, 2] = d
        m[:3, 3] = origin
        return Transform(m)

    @staticmethod
    def perspective(fov_deg: float, near: float, far: float) -> "Transform":
        """Projection used by the perspective camera (src/perspective.cpp:60-76)."""
        recip = 1.0 / (far - near)
        cot = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
        m = np.array(
            [
                [cot, 0, 0, 0],
                [0, cot, 0, 0],
                [0, 0, far * recip, -near * far * recip],
                [0, 0, 1, 0],
            ]
        )
        return Transform(m)


# -- batched device-side application ---------------------------------------

def apply_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """m: (4,4); p: (..., 3)."""
    r = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3] + m[3, 3]
    return r / w[..., None]


def apply_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return v @ m[:3, :3].T


def apply_normal(m_inv: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return n @ m_inv[:3, :3]
