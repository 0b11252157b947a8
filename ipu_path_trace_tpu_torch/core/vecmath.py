"""SoA 3-vector math over torch tensors.

Counterpart of ``ipu_path_trace_tpu/core/vecmath.py``: vectors are three
separate component tensors (structure of arrays), the layout every
kernel of the port reads and writes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    """A batch of 3-vectors in SoA layout."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s) -> "Vec3":
        """Scalar (or per-lane scalar tensor) multiply."""
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def cwise(self, o: "Vec3") -> "Vec3":
        """Componentwise product (``light::Vector::cwiseProduct``)."""
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm2(self) -> torch.Tensor:
        return self.dot(self)

    def normalized(self) -> "Vec3":
        return self * (1.0 / torch.sqrt(self.norm2()))

    def where(self, mask: torch.Tensor, other: "Vec3") -> "Vec3":
        """Select self where mask else other (per lane)."""
        return Vec3(
            torch.where(mask, self.x, other.x),
            torch.where(mask, self.y, other.y),
            torch.where(mask, self.z, other.z),
        )

    @staticmethod
    def full(shape, cx, cy, cz, *, device, dtype=torch.float32) -> "Vec3":
        return Vec3(
            torch.full(shape, cx, dtype=dtype, device=device),
            torch.full(shape, cy, dtype=dtype, device=device),
            torch.full(shape, cz, dtype=dtype, device=device),
        )

    @staticmethod
    def zeros(shape, *, device, dtype=torch.float32) -> "Vec3":
        z = torch.zeros(shape, dtype=dtype, device=device)
        return Vec3(z, z, z)

    def stack(self) -> torch.Tensor:
        """(3, ...) dense tensor, the kernels' row layout."""
        return torch.stack([self.x, self.y, self.z])

    @staticmethod
    def unstack(t: torch.Tensor) -> "Vec3":
        """Inverse of :meth:`stack` for a (3, ...) tensor."""
        return Vec3(t[0], t[1], t[2])


def orthonormal_basis(n: Vec3) -> tuple[Vec3, Vec3]:
    """Two tangents orthogonal to unit vectors ``n`` (branchless).

    Picks the larger-magnitude of x/y to stabilise the reciprocal length;
    both branches are evaluated, so the denominators are clamped to keep
    the unselected branch finite.
    """
    use_x = torch.abs(n.x) > torch.abs(n.y)
    zero = torch.zeros_like(n.x)
    inv_a = 1.0 / torch.sqrt(torch.clamp_min(n.x * n.x + n.z * n.z, 1e-20))
    va = Vec3(-n.z * inv_a, zero, n.x * inv_a)
    inv_b = 1.0 / torch.sqrt(torch.clamp_min(n.y * n.y + n.z * n.z, 1e-20))
    vb = Vec3(zero, n.z * inv_b, -n.y * inv_b)
    t1 = va.where(use_x, vb)
    t2 = n.cross(t1)
    return t1, t2
