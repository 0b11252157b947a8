"""Independent NumPy twin of the renderer - the golden test oracle.

The port's own copy of ``ipu_path_trace_tpu/cpu/oracle.py``: a
from-scratch NumPy implementation of the render math (camera,
sphere/disc intersection, BSDFs, russian roulette, equirect environment
lookup, NIF MLP) that shares no code with the renderer it checks - here
the port's kernels (K1, K2, K3) and their plain PyTorch versions.  It
imports numpy only.

When driven with the same random streams as the renderer's host-noise
mode (render/wavefront.py: an (S, 4 + 4L, P) array, one sample's rows
split by ``oracle_streams``), images agree to float32 rounding - a far
stronger check than statistical RMSE.  ``oracle_scene_from`` takes the
port's ``core.scene.Scene``; the NIF env reads ``models.nif``'s
``NifWeights`` and ``NifMetaData`` (``layers[i].kernel``, ``.bias``,
``embedding_dimension``, ``max``, ``mean``, ``log_tone_map``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

_EPS = 3e-5  # must match core.geometry.EPS
_DIFFUSE_SCALE = 0.1
_REFRACT_WEIGHT = 1.15


@dataclasses.dataclass
class OracleScene:
    sphere_center: np.ndarray  # (S, 3)
    sphere_radius: np.ndarray  # (S,)
    disc_normal: np.ndarray  # (D, 3)
    disc_center: np.ndarray  # (D, 3)
    disc_radius: np.ndarray  # (D,)
    colour: np.ndarray  # (N, 3)
    emission: np.ndarray  # (N, 3)
    material: np.ndarray  # (N,) 0 diffuse / 1 specular / 2 refractive


def oracle_scene_from(scene) -> OracleScene:
    """Convert a core.scene.Scene (torch tensors, any device) into plain numpy."""

    def host(t, dtype):
        return np.asarray(t.detach().cpu().numpy(), dtype)

    return OracleScene(
        sphere_center=host(scene.sphere_center, np.float32),
        sphere_radius=host(scene.sphere_radius, np.float32),
        disc_normal=host(scene.disc_normal, np.float32),
        disc_center=host(scene.disc_center, np.float32),
        disc_radius=host(scene.disc_radius, np.float32),
        colour=host(scene.colour, np.float32),
        emission=host(scene.emission, np.float32),
        material=host(scene.material, np.int32),
    )


def oracle_streams(noise) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One sample of host noise, (4 + 4L, P) in the kernels' row layout
    (ops/trace.py: [0:2] the distributed AA jitter, [2:4] the lens
    uniforms, [4 + 4b : 8 + 4b] bounce b's [rr, u1, u2, fresnel]), as the
    oracle's (aa (2, P), lens (2, P), uniforms (L, 4, P)) float32."""
    noise = np.asarray(noise, np.float32)
    return noise[0:2], noise[2:4], noise[4:].reshape(-1, 4, noise.shape[1])


def _normalize(v):
    return v / np.sqrt(np.sum(v * v, axis=-1, keepdims=True))


def _camera_rays(cols, rows, width, height, fov):
    x = ((2.0 * cols - width) / width) * np.tan(fov / 2.0)
    y = -((2.0 * rows - height) / height) * np.tan((height / width) * fov / 2.0)
    d = np.stack([x, y, np.full_like(x, -1.0)], axis=-1).astype(np.float32)
    return _normalize(d)


def _intersect(scene: OracleScene, o, d):
    """Nearest-hit over all objects. Returns (t, obj) with t=inf for miss."""
    p = o.shape[0]
    n_sph = scene.sphere_center.shape[0]
    n_dsc = scene.disc_center.shape[0]
    ts = np.full((p, n_sph + n_dsc), np.inf, np.float32)
    for s in range(n_sph):
        oc = o - scene.sphere_center[s]
        b = 2.0 * np.sum(oc * d, axis=-1)
        c = np.sum(oc * oc, axis=-1) - scene.sphere_radius[s] ** 2
        disc = b * b - 4.0 * c
        ok = disc >= 0.0
        sq = np.sqrt(np.where(ok, disc, 0.0))
        near = (-b - sq) / 2.0
        far = (-b + sq) / 2.0
        t = np.where(near > _EPS, near, np.where(far > _EPS, far, np.inf))
        ts[:, s] = np.where(ok, t, np.inf)
    for k in range(n_dsc):
        nrm = scene.disc_normal[k]
        denom = d @ nrm
        num = (scene.disc_center[k] - o) @ nrm
        with np.errstate(divide="ignore", invalid="ignore"):
            # t may be +-inf (parallel ray) or nan; hit_p then contains
            # inf*0 garbage on those lanes.  Both are masked out by `ok`
            # below: parallel lanes fail |denom| > 1e-12, inf-t lanes get
            # inf/nan r2 which compares False against radius^2, and nan
            # compares False everywhere.  Silence the transient warnings.
            t = num / denom
            hit_p = o + d * t[:, None]
            r2 = np.sum((hit_p - scene.disc_center[k]) ** 2, axis=-1)
            ok = (np.abs(denom) > 1e-12) & (t > _EPS) & (r2 <= scene.disc_radius[k] ** 2)
        ts[:, n_sph + k] = np.where(ok, t, np.inf)
    obj = np.argmin(ts, axis=1).astype(np.int32)
    t = ts[np.arange(p), obj]
    return t, obj


def _normals(scene: OracleScene, obj, point):
    n_sph = scene.sphere_center.shape[0]
    out = np.zeros_like(point)
    is_sph = obj < n_sph
    if n_sph:
        idx = np.clip(obj, 0, n_sph - 1)
        ns = point - scene.sphere_center[idx]
        ns = ns / np.maximum(np.sqrt(np.sum(ns * ns, axis=-1, keepdims=True)), 1e-10)
        out[is_sph] = ns[is_sph]
    if scene.disc_center.shape[0]:
        idx = np.clip(obj - n_sph, 0, scene.disc_center.shape[0] - 1)
        out[~is_sph] = scene.disc_normal[idx][~is_sph]
    return out


def _ons(n):
    """Orthonormal basis matching the smallpaint 'ons' construction."""
    t1 = np.zeros_like(n)
    use_x = np.abs(n[:, 0]) > np.abs(n[:, 1])
    inv_a = 1.0 / np.sqrt(np.maximum(n[:, 0] ** 2 + n[:, 2] ** 2, 1e-20))
    inv_b = 1.0 / np.sqrt(np.maximum(n[:, 1] ** 2 + n[:, 2] ** 2, 1e-20))
    t1[use_x, 0] = (-n[:, 2] * inv_a)[use_x]
    t1[use_x, 2] = (n[:, 0] * inv_a)[use_x]
    t1[~use_x, 1] = (n[:, 2] * inv_b)[~use_x]
    t1[~use_x, 2] = (-n[:, 1] * inv_b)[~use_x]
    t2 = np.cross(n, t1)
    return t1, t2


def _diffuse_dir(n, u1, u2):
    t1, t2 = _ons(n)
    z = u1
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    phi = 2.0 * np.pi * u2
    sx = (np.cos(phi) * r)[:, None]
    sy = (np.sin(phi) * r)[:, None]
    sz = z[:, None]
    d = t1 * sx + t2 * sy + n * sz
    return d, np.sum(d * n, axis=-1)


def _reflect(d, n):
    return d - n * (2.0 * np.sum(d * n, axis=-1, keepdims=True))


def _refract(d, n, ri, rand):
    r0 = ((1.0 - ri) / (1.0 + ri)) ** 2
    inside = np.sum(d * n, axis=-1) > 0.0
    nl = np.where(inside[:, None], -n, n)
    eta = np.where(inside, ri, 1.0 / ri)
    cost1 = -np.sum(d * nl, axis=-1)
    cost2 = 1.0 - eta * eta * (1.0 - cost1 * cost1)
    rprob = r0 + (1.0 - r0) * (1.0 - cost1) ** 5
    do_refract = (cost2 > 0.0) & (rand > rprob)
    sq = np.sqrt(np.maximum(cost2, 0.0))
    d_refr = _normalize(d * eta[:, None] + nl * (eta * cost1 - sq)[:, None])
    d_refl = _normalize(d + nl * (2.0 * cost1)[:, None])
    return np.where(do_refract[:, None], d_refr, d_refl), do_refract


def _equirect_uv(d, azimuth):
    theta = np.arccos(np.clip(d[:, 1], -1.0, 1.0))
    phi = np.arctan2(d[:, 2], d[:, 0]) + azimuth
    two_pi = 2.0 * np.pi
    phi = np.where(phi < 0.0, phi + two_pi, np.where(phi > two_pi, phi - two_pi, phi))
    return theta / np.pi, phi / two_pi


def _eval_env(env, u, v):
    """env is (kind, payload); see tests for construction helpers."""
    kind = env[0]
    if kind == "constant":
        c = np.asarray(env[1], np.float32)
        return np.broadcast_to(c, (u.shape[0], 3)).copy()
    if kind == "texture":
        tex = env[1]
        h, w = tex.shape[:2]
        r = np.clip(np.round(np.clip(u, 0, 1) * (h - 1)).astype(np.int64), 0, h - 1)
        c = np.clip(np.round(np.clip(v, 0, 1) * (w - 1)).astype(np.int64), 0, w - 1)
        return tex[r, c].astype(np.float32)
    if kind == "nif":
        weights, meta = env[1], env[2]
        bgr = _nif_forward(weights, meta, u, v)
        return bgr[:, ::-1].copy()  # channel reversal (codelets.cpp:377-378)
    raise ValueError(f"unknown env kind {kind}")


def _nif_forward(weights, meta, u, v):
    """float32 NumPy twin of the NIF MLP (NifModel.cpp:185-245,299-326)."""
    e = meta.embedding_dimension
    coeffs = (2.0 ** np.arange(e)).astype(np.float32)
    uu = 2.0 * (u.astype(np.float32) - 1.0)
    vv = 2.0 * (v.astype(np.float32) - 1.0)
    pu = uu[:, None] * coeffs
    pv = vv[:, None] * coeffs
    feats = np.concatenate([np.sin(pu), np.sin(pv), np.cos(pu), np.cos(pv)], axis=1)
    x = feats
    for i, layer in enumerate(weights.layers):
        k = layer.kernel.astype(np.float32)
        if x.shape[1] != k.shape[0]:
            x = np.concatenate([x, feats], axis=1)
        x = x @ k
        if layer.bias is not None:
            x = x + layer.bias.astype(np.float32)
        if i != len(weights.layers) - 1:
            x = np.maximum(x, 0.0)
    y = x * meta.max + meta.mean[None, :]
    if meta.log_tone_map:
        y = np.exp(y)
    return y


def trace_sample_oracle(
    scene: OracleScene,
    cols,
    rows,
    width,
    height,
    *,
    fov,
    aa_scale,
    azimuth,
    refractive_index,
    stop_prob,
    roulette_depth,
    max_path_length,
    aa,  # (2, P) jitter noise
    uniforms,  # (L, 4, P) per-bounce [rr, u1, u2, fresnel]
    env,
    lens=None,  # (2, P) lens-disk uniforms; None = pinhole
    aperture=0.0,
    focal_distance=1.0,
):
    """Trace one sample per pixel; returns (radiance (P,3), path_len (P,))."""
    p = cols.shape[0]
    c = cols.astype(np.float32) + aa_scale * aa[0]
    r = rows.astype(np.float32) + aa_scale * aa[1]
    d = _camera_rays(c, r, float(width), float(height), fov)
    o = np.zeros((p, 3), np.float32)
    if lens is not None and aperture > 0.0:
        # Thin-lens DoF (wavefront.apply_thin_lens): jitter the origin on
        # an aperture disk and refocus through the plane z = -focal.
        # aperture == 0 must keep the pinhole (o, d) BIT-exact like the
        # jax path's dof select - the refocus renormalisation would flip
        # last ulps and spuriously diverge knife-edge lanes.
        lr = aperture * np.sqrt(lens[0])
        lphi = 2.0 * np.pi * lens[1]
        o[:, 0] = lr * np.cos(lphi)
        o[:, 1] = lr * np.sin(lphi)
        t_f = focal_distance / np.maximum(-d[:, 2], 1e-8)
        fd = d * t_f[:, None] - o
        d = fd / np.linalg.norm(fd, axis=1, keepdims=True)
    throughput = np.ones((p, 3), np.float32)
    radiance = np.zeros((p, 3), np.float32)
    alive = np.ones(p, bool)
    esc_dir = np.zeros((p, 3), np.float32)
    esc_w = np.zeros((p, 3), np.float32)
    escaped = np.zeros(p, bool)
    path_len = np.zeros(p, np.int32)

    for depth in range(max_path_length):
        rr_rand, u1, u2, fr = uniforms[depth]
        rr_on = depth >= roulette_depth
        rr_factor = 1.0 / (1.0 - stop_prob) if rr_on else 1.0
        if rr_on:
            alive = alive & ~(rr_rand <= stop_prob)

        t, obj = _intersect(scene, o, d)
        hit_valid = np.isfinite(t)
        point = o + d * np.where(hit_valid, t, 0.0)[:, None]
        normal = _normals(scene, obj, point)
        emissive = np.any(scene.emission[obj] != 0.0, axis=1)

        escaped_now = alive & ~hit_valid
        esc_dir[escaped_now] = d[escaped_now]
        esc_w[escaped_now] = throughput[escaped_now] * rr_factor
        escaped |= escaped_now

        emit_now = alive & hit_valid & emissive
        radiance[emit_now] += (
            throughput[emit_now] * scene.emission[obj[emit_now]] * rr_factor
        )
        alive = alive & hit_valid & ~emissive

        mat = scene.material[obj]
        d_diff, cos_t = _diffuse_dir(normal, u1, u2)
        d_spec = _reflect(d, normal)
        d_refr, refracted = _refract(d, normal, refractive_index, fr)

        new_d = np.where(
            (mat == 0)[:, None],
            d_diff,
            np.where((mat == 1)[:, None], d_spec, d_refr),
        )
        col = scene.colour[obj]
        w_diff = col * (cos_t * _DIFFUSE_SCALE * rr_factor)[:, None]
        w_spec = np.full((p, 3), rr_factor, np.float32)
        tint = np.where(refracted[:, None], col, 1.0)
        w_refr = tint * (_REFRACT_WEIGHT * rr_factor)
        scale = np.where(
            (mat == 0)[:, None], w_diff, np.where((mat == 1)[:, None], w_spec, w_refr)
        )
        throughput = np.where(alive[:, None], throughput * scale, throughput)
        o = np.where(alive[:, None], point, o)
        d = np.where(alive[:, None], new_d, d)
        path_len += (escaped_now | emit_now | alive).astype(np.int32)

    u, v = _equirect_uv(esc_dir, azimuth)
    u = np.where(escaped, u, 0.0)
    v = np.where(escaped, v, 0.0)
    env_rgb = _eval_env(env, u, v)
    radiance = radiance + esc_w * env_rgb
    return radiance.astype(np.float32), path_len


def render_oracle(
    scene: OracleScene,
    width,
    height,
    spp,
    *,
    env,
    stream_fn,
    fov=np.pi / 2,
    aa_scale=0.3,
    azimuth=0.0,
    refractive_index=1.5,
    stop_prob=0.3,
    roulette_depth=3,
    max_path_length=10,
):
    """Render a full image by averaging spp oracle samples.

    stream_fn(sample_idx) -> (aa (2,P), uniforms (L,4,P)) supplies the
    random streams; pass the jax-derived streams for parity tests or a
    numpy-based generator for standalone use.
    """
    cols, rows = np.meshgrid(np.arange(width), np.arange(height))
    cols = cols.ravel().astype(np.float32)
    rows = rows.ravel().astype(np.float32)
    acc = np.zeros((width * height, 3), np.float32)
    for s in range(spp):
        aa, uniforms = stream_fn(s)
        rad, _ = trace_sample_oracle(
            scene,
            cols,
            rows,
            width,
            height,
            fov=fov,
            aa_scale=aa_scale,
            azimuth=azimuth,
            refractive_index=refractive_index,
            stop_prob=stop_prob,
            roulette_depth=roulette_depth,
            max_path_length=max_path_length,
            aa=aa,
            uniforms=uniforms,
            env=env,
        )
        acc += rad
    return (acc / spp).reshape(height, width, 3)
