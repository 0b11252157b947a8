"""The plain reference's scene, camera, intersection and materials.

A frozen copy of the renderer's plain PyTorch versions, operation for
operation, so that on one device its trace rounds where the renderer's
kernels round (they are built without FMA contraction to replay exactly
this arithmetic).  It imports nothing of the renderer: a later change to
the renderer cannot move it.

Scenes: the built-in scene (five spheres over a floor disc) or a JSON
scene file ({"objects": [{"type": "sphere" | "disc", ...}]}).
"""

from __future__ import annotations

import enum
import json
import math
from typing import NamedTuple

import numpy as np
import torch

EPS = 3e-5  # self-intersection epsilon
_INF = float("inf")
DIFFUSE_SCALE = 0.1
REFRACT_WEIGHT = 1.15
PI = math.pi
TWO_PI = 2.0 * math.pi


class Vec3(NamedTuple):
    """A batch of 3-vectors, one tensor per component."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s) -> "Vec3":
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def cwise(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(self.y * o.z - self.z * o.y, self.z * o.x - self.x * o.z,
                    self.x * o.y - self.y * o.x)

    def norm2(self) -> torch.Tensor:
        return self.dot(self)

    def normalized(self) -> "Vec3":
        return self * (1.0 / torch.sqrt(self.norm2()))

    def where(self, mask: torch.Tensor, other: "Vec3") -> "Vec3":
        return Vec3(torch.where(mask, self.x, other.x), torch.where(mask, self.y, other.y),
                    torch.where(mask, self.z, other.z))

    @staticmethod
    def full(shape, cx, cy, cz, *, device) -> "Vec3":
        return Vec3(*(torch.full(shape, c, dtype=torch.float32, device=device)
                      for c in (cx, cy, cz)))

    @staticmethod
    def zeros(shape, *, device) -> "Vec3":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return Vec3(z, z, z)


def orthonormal_basis(n: Vec3) -> tuple[Vec3, Vec3]:
    use_x = torch.abs(n.x) > torch.abs(n.y)
    zero = torch.zeros_like(n.x)
    inv_a = 1.0 / torch.sqrt(torch.clamp_min(n.x * n.x + n.z * n.z, 1e-20))
    va = Vec3(-n.z * inv_a, zero, n.x * inv_a)
    inv_b = 1.0 / torch.sqrt(torch.clamp_min(n.y * n.y + n.z * n.z, 1e-20))
    vb = Vec3(zero, n.z * inv_b, -n.y * inv_b)
    t1 = va.where(use_x, vb)
    return t1, n.cross(t1)


# ------------------------------------------------------------------ scene ----

class Material(enum.IntEnum):
    DIFFUSE = 0
    SPECULAR = 1
    REFRACTIVE = 2


class Scene(NamedTuple):
    """S spheres followed by D discs."""

    sphere_center: torch.Tensor  # (S, 3) f32
    sphere_radius: torch.Tensor  # (S,)
    disc_normal: torch.Tensor  # (D, 3)
    disc_center: torch.Tensor  # (D, 3)
    disc_radius: torch.Tensor  # (D,)
    colour: torch.Tensor  # (S + D, 3)
    emission: torch.Tensor  # (S + D, 3)
    emissive: torch.Tensor  # (S + D,) bool
    material: torch.Tensor  # (S + D,) int32

    @property
    def num_spheres(self) -> int:
        return self.sphere_center.shape[0]

    @property
    def num_discs(self) -> int:
        return self.disc_radius.shape[0]

    def to(self, device) -> "Scene":
        return Scene(*(t.to(device) for t in self))


def make_scene(spheres, discs, colours, emissions, materials, *, device="cpu") -> Scene:
    n = len(spheres) + len(discs)
    if not (len(colours) == len(emissions) == len(materials) == n):
        raise ValueError("per-object attribute counts must match the object count")
    f32 = np.float32
    disc_normal = np.array([n_ for n_, _, _ in discs], f32).reshape(len(discs), 3)
    if len(discs):
        disc_normal = disc_normal / np.linalg.norm(disc_normal, axis=1, keepdims=True)
    emission = np.array(emissions, f32).reshape(n, 3)
    arrays = (np.array([c for c, _ in spheres], f32).reshape(len(spheres), 3),
              np.array([r for _, r in spheres], f32), disc_normal,
              np.array([c for _, c, _ in discs], f32).reshape(len(discs), 3),
              np.array([r for _, _, r in discs], f32), np.array(colours, f32).reshape(n, 3),
              emission, np.any(emission != 0.0, axis=1),
              np.array([int(m) for m in materials], np.int32))
    return Scene(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays))


def default_scene(device="cpu") -> Scene:
    """Five spheres (diffuse, mirror, glass, a diffuse core in a glass
    shell) over a diffuse floor disc, the colour gain 2 baked in."""
    gain = 2.0
    sphere_colour = (1.0 * gain, 0.89 * gain, 0.55 * gain)
    clear_coat_colour = (0.8 * gain, 0.06 * gain, 0.391 * gain)
    floor_colour = (0.98 * gain, 0.76 * gain, 0.66 * gain)
    one, zero, tint = (1.0, 1.0, 1.0), (0.0, 0.0, 0.0), (0.75, 0.75, 0.75)
    M = Material
    return make_scene(
        spheres=[((-1.8575, -0.98714, -3.6), 0.6), ((0.74795, -0.55, -4.3816), 1.05),
                 ((1.9929, -1.08666, -3.23), 0.5), ((-0.19931, -1.183, -2.75), 0.4),
                 ((-0.19931, -1.183, -2.75), 0.4001)],
        discs=[((0.0, 1.0, 0.0), (0.0, -1.6, -5.22), 3.5)],
        colours=[sphere_colour, one, tint, clear_coat_colour, one, floor_colour],
        emissions=[zero] * 6,
        materials=[M.DIFFUSE, M.SPECULAR, M.REFRACTIVE, M.DIFFUSE, M.REFRACTIVE, M.DIFFUSE],
        device=device)


_MATERIALS = {"diffuse": Material.DIFFUSE, "specular": Material.SPECULAR,
              "refractive": Material.REFRACTIVE}


def load_scene(path: str, device="cpu") -> Scene:
    """A JSON scene file: spheres packed before discs, file order kept."""
    with open(path) as f:
        doc = json.load(f)
    spheres, discs, attrs = [], [], {"sphere": [], "disc": []}
    for i, obj in enumerate(doc["objects"]):
        kind = obj["type"]
        if kind not in attrs:
            raise ValueError(f"objects[{i}].type {kind!r} is neither 'sphere' nor 'disc'")
        radius = float(obj["radius"])
        if kind == "sphere":
            spheres.append((tuple(map(float, obj["center"])), radius))
        else:
            discs.append((tuple(map(float, obj["normal"])), tuple(map(float, obj["center"])),
                          radius))
        attrs[kind].append((tuple(map(float, obj.get("colour", (1.0, 1.0, 1.0)))),
                            tuple(map(float, obj.get("emission", (0.0, 0.0, 0.0)))),
                            _MATERIALS[obj.get("material", "diffuse")]))
    ordered = attrs["sphere"] + attrs["disc"]
    return make_scene(spheres, discs, [a[0] for a in ordered], [a[1] for a in ordered],
                      [a[2] for a in ordered], device=device)


def scene_for(scene_file: str, device="cpu") -> Scene:
    """The configuration's scene: "" is the built-in one."""
    return load_scene(scene_file, device) if scene_file else default_scene(device)


# ----------------------------------------------------------------- camera ----

def pixel_to_ray(col: torch.Tensor, row: torch.Tensor, width: int, height: int,
                 fov: float) -> Vec3:
    """Fractional pixel coordinates -> the unnormalised ray (x, y, -1)."""
    dev = col.device
    w = torch.tensor(float(width), device=dev)
    h = torch.tensor(float(height), device=dev)
    half_fov = torch.tensor(fov, dtype=torch.float32, device=dev) * 0.5
    x = ((2.0 * col - w) / w) * torch.tan(half_fov)
    y = -((2.0 * row - h) / h) * torch.tan((h / w) * half_fov)
    return Vec3(x, y, torch.full_like(x, -1.0))


def equirect_uv(direction: Vec3, azimuth: float) -> tuple[torch.Tensor, torch.Tensor]:
    y = torch.clamp(direction.y, -1.0, 1.0)
    theta = torch.arccos(y)
    phi = torch.atan2(direction.z, direction.x) + torch.tensor(
        azimuth, dtype=torch.float32, device=y.device)
    phi = torch.where(phi < 0.0, phi + TWO_PI, torch.where(phi > TWO_PI, phi - TWO_PI, phi))
    return theta * (1.0 / PI), phi * (1.0 / TWO_PI)


# ----------------------------------------------------------- intersection ----

class Hit(NamedTuple):
    valid: torch.Tensor
    point: Vec3
    normal: Vec3
    colour: Vec3
    emission: Vec3
    emissive: torch.Tensor
    material: torch.Tensor


def _sphere_t(cx, cy, cz, radius, o: Vec3, d: Vec3) -> torch.Tensor:
    ox = o.x - cx
    oy = o.y - cy
    oz = o.z - cz
    b = 2.0 * (ox * d.x + oy * d.y + oz * d.z)
    c = ox * ox + oy * oy + oz * oz - radius * radius
    disc = b * b - 4.0 * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    near = (-b - sq) * 0.5
    far = (-b + sq) * 0.5
    inf = torch.full_like(near, _INF)
    t = torch.where(near > EPS, near, torch.where(far > EPS, far, inf))
    return torch.where(disc >= 0.0, t, inf)


def _disc_t(nx, ny, nz, cx, cy, cz, radius, o: Vec3, d: Vec3) -> torch.Tensor:
    denom = d.x * nx + d.y * ny + d.z * nz
    num = (cx - o.x) * nx + (cy - o.y) * ny + (cz - o.z) * nz
    ok_denom = torch.abs(denom) > 1e-12
    t = num / torch.where(ok_denom, denom, torch.full_like(denom, 1e-12))
    px = o.x + d.x * t - cx
    py = o.y + d.y * t - cy
    pz = o.z + d.z * t - cz
    inside = px * px + py * py + pz * pz <= radius * radius
    ok = (t > EPS) & inside & ok_denom
    return torch.where(ok, t, torch.full_like(t, _INF))


def intersect_scene(scene: Scene, o: Vec3, d: Vec3) -> Hit:
    """Nearest hit of each ray (spheres first, then discs; the first of
    equal distances wins)."""
    num_s = scene.num_spheres
    shape, dev = o.x.shape, o.x.device
    best_t = torch.full(shape, _INF, device=dev)
    nrm = Vec3.zeros(shape, device=dev)
    colour = Vec3.zeros(shape, device=dev)
    emission = Vec3.zeros(shape, device=dev)
    emissive = torch.zeros(shape, dtype=torch.bool, device=dev)
    material = torch.zeros(shape, dtype=torch.int32, device=dev)
    win_c = Vec3.zeros(shape, device=dev)
    won_sphere = torch.zeros(shape, dtype=torch.bool, device=dev)

    def take(k, t_k):
        nonlocal best_t, colour, emission, emissive, material
        closer = t_k < best_t
        best_t = torch.where(closer, t_k, best_t)
        colour = Vec3(*(torch.where(closer, scene.colour[k, i], c) for i, c in enumerate(colour)))
        emission = Vec3(*(torch.where(closer, scene.emission[k, i], e)
                          for i, e in enumerate(emission)))
        emissive = torch.where(closer, scene.emissive[k], emissive)
        material = torch.where(closer, scene.material[k], material)
        return closer

    for k in range(num_s):
        cx, cy, cz = scene.sphere_center[k]
        closer = take(k, _sphere_t(cx, cy, cz, scene.sphere_radius[k], o, d))
        win_c = Vec3(torch.where(closer, cx, win_c.x), torch.where(closer, cy, win_c.y),
                     torch.where(closer, cz, win_c.z))
        won_sphere = won_sphere | closer
    for j in range(scene.num_discs):
        nx, ny, nz = scene.disc_normal[j]
        cx, cy, cz = scene.disc_center[j]
        closer = take(num_s + j, _disc_t(nx, ny, nz, cx, cy, cz, scene.disc_radius[j], o, d))
        nrm = Vec3(torch.where(closer, nx, nrm.x), torch.where(closer, ny, nrm.y),
                   torch.where(closer, nz, nrm.z))
        won_sphere = won_sphere & ~closer

    valid = torch.isfinite(best_t)
    t_safe = torch.where(valid, best_t, torch.zeros_like(best_t))
    point = Vec3(o.x + d.x * t_safe, o.y + d.y * t_safe, o.z + d.z * t_safe)
    if num_s:
        n_s = point - win_c
        inv = 1.0 / torch.sqrt(torch.clamp_min(n_s.norm2(), 1e-20))
        nrm = (n_s * inv).where(won_sphere, nrm)
    return Hit(valid=valid, point=point, normal=nrm, colour=colour, emission=emission,
               emissive=emissive, material=material)


# -------------------------------------------------------------- materials ----

def sample_diffuse(normal: Vec3, u1, u2) -> tuple[Vec3, torch.Tensor]:
    t1, t2 = orthonormal_basis(normal)
    r = torch.sqrt(torch.clamp_min(1.0 - u1 * u1, 0.0))
    phi = TWO_PI * u2
    s = Vec3(torch.cos(phi) * r, torch.sin(phi) * r, u1)
    d = t1 * s.x + t2 * s.y + normal * s.z
    return d, d.dot(normal)


def reflect(d: Vec3, n: Vec3) -> Vec3:
    return d - n * (2.0 * d.dot(n))


def refract(d: Vec3, n: Vec3, refractive_index, rand) -> tuple[Vec3, torch.Tensor]:
    """Glass: Schlick's Fresnel choice between refraction and reflection."""
    n_idx = refractive_index
    r0 = (1.0 - n_idx) / (1.0 + n_idx)
    r0 = r0 * r0
    inside = d.dot(n) > 0.0
    nl = n.where(~inside, -n)
    eta = torch.where(inside, n_idx, 1.0 / n_idx)
    cost1 = -d.dot(nl)
    cost2 = 1.0 - eta * eta * (1.0 - cost1 * cost1)
    p1 = 1.0 - cost1
    p2 = p1 * p1
    rprob = r0 + (1.0 - r0) * (p2 * p2 * p1)
    do_refract = (cost2 > 0.0) & (rand > rprob)
    sqrt_cost2 = torch.sqrt(torch.clamp_min(cost2, 0.0))
    d_refr = (d * eta + nl * (eta * cost1 - sqrt_cost2)).normalized()
    d_refl = (d + nl * (2.0 * cost1)).normalized()
    return d_refr.where(do_refract, d_refl), do_refract
