"""Core modules of the PyTorch port against their JAX counterparts.

The same numpy-seeded inputs go through ``ipu_path_trace_tpu.core`` and
``ipu_path_trace_tpu_torch.core``.  Both run float32 on the CPU; XLA and
PyTorch may round a product or fuse differently, so floats are held to
1e-5 relative, and booleans/integers exactly - except intersections,
where a ray tangent to a surface may flip between hit and miss: the
reference's own rule (tests/test_megastep.py:79-90) applies, exact on at
least 99.5% of lanes and the float tolerance on the rest.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipu_path_trace_tpu.core import camera as jcamera
from ipu_path_trace_tpu.core import envmap as jenvmap
from ipu_path_trace_tpu.core import geometry as jgeometry
from ipu_path_trace_tpu.core import materials as jmaterials
from ipu_path_trace_tpu.core import records as jrecords
from ipu_path_trace_tpu.core import scene as jscene
from ipu_path_trace_tpu.core import vecmath as jvecmath
from ipu_path_trace_tpu.film import film as jfilm
from ipu_path_trace_tpu.film import imageio as jimageio
from ipu_path_trace_tpu.render import params as jparams
from ipu_path_trace_tpu.runtime import worklist as jworklist
from ipu_path_trace_tpu_torch.core import camera, envmap, geometry, materials, records, scene
from ipu_path_trace_tpu_torch.core.vecmath import Vec3, orthonormal_basis
from ipu_path_trace_tpu_torch.film import film, imageio
from ipu_path_trace_tpu_torch.render import params
from ipu_path_trace_tpu_torch.runtime import worklist

N = 2000
RTOL, ATOL = 1e-5, 1e-6


def _unit(rng, n=N):
    d = rng.normal(size=(3, n)).astype(np.float32)
    return d / np.linalg.norm(d, axis=0, keepdims=True)


def _pair(a):
    """(torch Vec3, jax Vec3) views of a (3, n) numpy array."""
    return (Vec3(*(torch.from_numpy(a[i].copy()) for i in range(3))),
            jvecmath.Vec3(*(jnp.asarray(a[i]) for i in range(3))))


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def _close3(got, ref, mask=None, rtol=RTOL, atol=ATOL):
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        if mask is not None:
            g, r = g[mask], r[mask]
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("field", jscene.Scene._fields)
def test_default_scene_arrays_equal(field):
    got = getattr(scene.default_scene(), field).numpy()
    ref = np.asarray(getattr(jscene.default_scene(), field))
    assert got.dtype == ref.dtype or (got.dtype == np.int32 and ref.dtype == np.int32)
    np.testing.assert_array_equal(got, ref)


def test_orthonormal_basis():
    n = _unit(np.random.default_rng(0))
    tn, jn = _pair(n)
    for g, r in zip(orthonormal_basis(tn), jvecmath.orthonormal_basis(jn)):
        _close3(g, r)


def _rays(seed):
    """Origins inside the default scene's box and unit directions."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-3, 3, N), rng.uniform(-1.6, 1, N),
                  rng.uniform(-6, 0, N)]).astype(np.float32)
    return o, _unit(rng)


@pytest.mark.parametrize("seed", [1, 2])
def test_intersect_scene(seed):
    o, d = _rays(seed)
    (to, jo), (td, jd) = _pair(o), _pair(d)
    got = geometry.intersect_scene(scene.default_scene(), to, td)
    ref = jgeometry.intersect_scene(jscene.default_scene(), jo, jd)
    flipped = got.valid.numpy() != np.asarray(ref.valid)
    assert flipped.mean() < 5e-3
    ok = ~flipped & np.asarray(ref.valid)
    assert ok.sum() > N // 4  # the rays really hit things
    _close(got.t.numpy()[ok], np.asarray(ref.t)[ok])
    _close3(got.point, ref.point, ok, atol=1e-5)
    _close3(got.normal, ref.normal, ok, atol=1e-5)
    _close3(got.colour, ref.colour, ok)
    np.testing.assert_array_equal(got.obj.numpy()[ok], np.asarray(ref.obj)[ok])
    np.testing.assert_array_equal(got.material.numpy()[ok], np.asarray(ref.material)[ok])
    np.testing.assert_array_equal(got.emissive.numpy()[ok], np.asarray(ref.emissive)[ok])


def test_sphere_and_disc_distance():
    o, d = _rays(3)
    (to, jo), (td, jd) = _pair(o), _pair(d)
    t = torch.tensor
    _close(geometry._sphere_t(t(0.7), t(-0.5), t(-4.3), t(1.05), to, td),
           jgeometry._sphere_t(0.7, -0.5, -4.3, 1.05, jo, jd))
    _close(geometry._disc_t(t(0.0), t(1.0), t(0.0), t(0.0), t(-1.6), t(-5.2), t(3.5), to, td),
           jgeometry._disc_t(0.0, 1.0, 0.0, 0.0, -1.6, -5.2, 3.5, jo, jd))


def test_sample_diffuse():
    rng = np.random.default_rng(4)
    n = _unit(rng)
    u1, u2 = rng.uniform(size=(2, N)).astype(np.float32)
    tn, jn = _pair(n)
    d, c = materials.sample_diffuse(tn, torch.from_numpy(u1), torch.from_numpy(u2))
    jd, jc = jmaterials.sample_diffuse(jn, jnp.asarray(u1), jnp.asarray(u2))
    _close3(d, jd, atol=1e-6)
    _close(c, jc)


def test_reflect():
    rng = np.random.default_rng(5)
    (td, jd), (tn, jn) = _pair(_unit(rng)), _pair(_unit(rng))
    _close3(materials.reflect(td, tn), jmaterials.reflect(jd, jn))


@pytest.mark.parametrize("index", [1.5, 1.33])
def test_refract(index):
    rng = np.random.default_rng(6)
    (td, jd), (tn, jn) = _pair(_unit(rng)), _pair(_unit(rng))
    rand = rng.uniform(size=N).astype(np.float32)
    got, got_r = materials.refract(td, tn, torch.tensor(index, dtype=torch.float32),
                                   torch.from_numpy(rand))
    ref, ref_r = jmaterials.refract(jd, jn, jnp.float32(index), jnp.asarray(rand))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(ref_r))
    _close3(got, ref, atol=1e-5)


@pytest.mark.parametrize("fov_deg", [90.0, 40.0])
def test_pixel_to_ray(fov_deg):
    rng = np.random.default_rng(7)
    col = rng.uniform(-1, 64, N).astype(np.float32)
    row = rng.uniform(-1, 48, N).astype(np.float32)
    fov = float(np.float32(np.deg2rad(fov_deg)))
    got = camera.pixel_to_ray(torch.from_numpy(col), torch.from_numpy(row), 64, 48, fov)
    ref = jcamera.pixel_to_ray(jnp.asarray(col), jnp.asarray(row), 64, 48, jnp.float32(fov))
    _close3(got, ref)


@pytest.mark.parametrize("azimuth", [0.0, 0.7, -2.0])
def test_equirect_uv(azimuth):
    td, jd = _pair(_unit(np.random.default_rng(8)))
    u, v = envmap.equirect_uv(td, azimuth)
    ju, jv = jenvmap.equirect_uv(jd, jnp.float32(azimuth))
    _close(u, ju)
    _close(v, jv)


@pytest.mark.parametrize("noise_type", camera.AA_NOISE_TYPES)
def test_aa_noise_distribution(noise_type):
    """Same distribution as the reference's jitter (different generator)."""
    z = camera.aa_noise(torch.Generator().manual_seed(3), (200_000,), noise_type).numpy()
    std = {"uniform": 1 / np.sqrt(3), "normal": 1.0, "truncated-normal": 0.9866}[noise_type]
    assert abs(z.mean()) < 0.01
    assert abs(z.std() - std) < 0.01
    bound = 1.0 if noise_type == "uniform" else (3.0 if noise_type == "truncated-normal" else 10)
    assert np.abs(z).max() <= bound


def test_record_dtype_and_worklist():
    assert records.TRACE_RECORD_DTYPE == jrecords.TRACE_RECORD_DTYPE
    wl = records.make_worklist(7, 5, padded_size=40)
    np.testing.assert_array_equal(wl, jrecords.make_worklist(7, 5, padded_size=40))


def test_device_batch_round_trip():
    rng = np.random.default_rng(9)
    wl = records.make_worklist(9, 4, padded_size=40)
    wl["r"], wl["g"], wl["b"] = rng.uniform(size=(3, 40)).astype(np.float32)
    wl["sampleCount"] = rng.integers(0, 0xFFFF, 40)
    wl["pathLength"] = rng.integers(0, 0xFFFF, 40)
    batch = records.to_device_batch(wl, "cpu")
    jbatch = jrecords.to_device_batch(wl)
    for name in records.WorkBatch._fields:
        np.testing.assert_array_equal(getattr(batch, name).numpy(),
                                      np.asarray(getattr(jbatch, name)))
    np.testing.assert_array_equal(records.from_device_batch(batch),
                                  jrecords.from_device_batch(jbatch))


def test_render_params_match():
    # The port's K3 shades escaping rays only, so it has no env_skip field.
    jfields = tuple(f for f in jparams.StaticConfig._fields if f != "env_skip")
    assert params.StaticConfig._fields == jfields
    assert params.StaticConfig() == tuple(getattr(jparams.StaticConfig(), f) for f in jfields)
    kw = dict(fov_degrees=70.0, aa_scale=0.4, env_rotation_degrees=30.0,
              refractive_index=1.4, stop_prob=0.2, roulette_depth=2,
              samples_per_step=8, aperture=0.1, focal_distance=3.0, seed=5)
    got, ref = params.RenderSettings.make(**kw), jparams.RenderSettings.make(**kw)
    assert got._fields == ref._fields
    for name in got._fields:
        assert getattr(got, name) == float(np.asarray(getattr(ref, name))), name


@pytest.mark.parametrize("wh", [(24, 24), (1104, 1000), (50, 30)])
def test_tracing_jobs_match(wh):
    w, h = wh
    assert (worklist.calculate_max_rays_per_tile(w, h)
            == jworklist.calculate_max_rays_per_tile(w, h))
    np.testing.assert_array_equal(worklist.create_tracing_jobs(w, h),
                                  jworklist.create_tracing_jobs(w, h))


def test_coherent_order_matches_reference():
    wl = worklist.create_tracing_jobs(48, 40)
    got = worklist.coherent_order(wl, scene.default_scene(), 48, 40, 90.0)
    ref = jworklist.coherent_order(wl, jscene.default_scene(), 48, 40, 90.0)
    np.testing.assert_array_equal(got, ref)


def test_film_and_tonemap_match():
    rng = np.random.default_rng(10)
    wl = records.make_worklist(12, 10, padded_size=130)
    wl["r"], wl["g"], wl["b"] = rng.uniform(0, 4, size=(3, 130)).astype(np.float32)
    wl["sampleCount"] = rng.integers(0, 5, 130)
    got, ref = film.Film(12, 10), jfilm.Film(12, 10)
    for f in (got, ref):
        f.accumulate(wl)
        f.accumulate(wl)
    np.testing.assert_allclose(got.hdr_at_step(2), ref.hdr_at_step(2), rtol=1e-6)
    np.testing.assert_array_equal(got.ldr(2, 0.5, 2.2), ref.ldr(2, 0.5, 2.2))


def test_exr_writer_bytes_match(tmp_path):
    hdr = np.random.default_rng(11).uniform(0, 8, (6, 5, 3)).astype(np.float32)
    imageio.write_exr(str(tmp_path / "a.exr"), hdr)
    jimageio.write_exr(str(tmp_path / "b.exr"), hdr)
    assert (tmp_path / "a.exr").read_bytes() == (tmp_path / "b.exr").read_bytes()
    np.testing.assert_array_equal(imageio.read_exr(str(tmp_path / "a.exr")), hdr)


def test_png_writer_round_trip(tmp_path):
    """The zlib PNG writer decodes to the same pixels with PIL."""
    from PIL import Image

    ldr = np.random.default_rng(12).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    imageio.write_png(str(tmp_path / "a.png"), ldr)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), ldr)
