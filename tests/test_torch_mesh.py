"""The port's sharded render step (parallel/mesh.py) on a virtual CPU mesh.

Against the JAX package's ``parallel/mesh.py`` (its XLA branch on the
8-device CPU mesh of tests/conftest.py): ``parse_mesh_shape`` gives the
same results and errors; ``sharded_render_step`` in host-noise mode, each
shard (i, j) fed the noise JAX's own step draws for fold_in(fold_in(key,
i), j) (render/wavefront.step_noise at the shard's lane count), matches on
8x1, 4x2 and 2x4 meshes with a constant env (the trace's rtol 1e-4, atol
3e-5) and a bf16 NIF (tests/test_torch_megastep.py's twin budget: median
relative error < 5e-3, max < 8e-2) on the lanes whose path lengths agree,
with exact sample counts.  The twin budget allows 0.5% of lanes a flipped
path length over its 3 samples; a lane here sums 2 x S samples, so the
allowance is that rate per sample times the lane's samples; the adaptive step on a 2x2 mesh over two steps,
JAX's megastep replaced by its reference composition (the XLA twin of
tests/test_megastep.py with the budgets and statistics), so no kernel
runs in interpret mode; and the image mean agrees with JAX's sharded
render's (5%, tests/test_mesh.py).

Against the port's own replay (probes/validate_mesh.replay): bit for bit
with one sample replica, within rtol 1e-6, atol 1e-7 with more, fused and
unfused; a padded worklist keeps its dummy records; one that does not
divide raises; Sobol replicas draw disjoint slices.  Sizes are
tests/test_mesh.py's: 32x24, max path 3, 2 samples a replica.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_megastep import SAMPLES as TWIN_SAMPLES
from test_torch_megastep import assert_matches_twin

from ipu_path_trace_tpu.core.envmap import equirect_uv
from ipu_path_trace_tpu.core.records import make_worklist
from ipu_path_trace_tpu.core.records import to_device_batch as jto_device_batch
from ipu_path_trace_tpu.core.scene import default_scene as jdefault_scene
from ipu_path_trace_tpu.core.vecmath import Vec3 as JVec3
from ipu_path_trace_tpu.models.envlight import ConstantEnv as JConstantEnv
from ipu_path_trace_tpu.models.envlight import NifEnv as JNifEnv
from ipu_path_trace_tpu.models.nif import make_params, make_synthetic_nif, nif_apply
from ipu_path_trace_tpu.parallel import mesh as jmesh
from ipu_path_trace_tpu.render import RenderSettings as JRenderSettings
from ipu_path_trace_tpu.render import StaticConfig as JStaticConfig
from ipu_path_trace_tpu.render.wavefront import step_noise as jstep_noise
from ipu_path_trace_tpu_torch.core.records import WorkBatch, to_device_batch
from ipu_path_trace_tpu_torch.core.scene import default_scene
from ipu_path_trace_tpu_torch.models.envlight import ConstantEnv, NifEnv
from ipu_path_trace_tpu_torch.models.nif import params_from_jax
from ipu_path_trace_tpu_torch.ops import megastep
from ipu_path_trace_tpu_torch.parallel import mesh
from ipu_path_trace_tpu_torch.probes.validate_mesh import compare, replay
from ipu_path_trace_tpu_torch.render.params import RenderSettings, StaticConfig

W, H, MAXLEN, SPP = 32, 24, 3, 2
COLOUR = (1.0, 0.9, 0.8)
CPU8 = ["cpu"] * 8
FLIP_FRACTION, TRACE_RTOL, TRACE_ATOL = 5e-3, 1e-4, 3e-5
BLOCK = 256  # the JAX adaptive step's budget block off the TPU (_INTERPRET_BLOCK)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the suite runs files side by side in workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jnif():
    weights, meta = make_synthetic_nif(key=0, hidden=32, num_hidden=2, skip_layer=1)
    return make_params(weights, meta, jnp.bfloat16)


def _envs(kind):
    """(JAX env, port env) of one kind."""
    if kind == "const":
        return JConstantEnv(colour=jnp.asarray(COLOUR)), ConstantEnv(COLOUR)
    params = _jnif()
    return JNifEnv(params=params), NifEnv(params_from_jax(params))


def _jax_noise(key, shape, n, cfg, samples):
    """noise[i][j]: JAX's step noise of shard (i, j) at its lane count."""
    px, sm = shape
    return [[torch.from_numpy(np.array(jstep_noise(
        jax.random.fold_in(jax.random.fold_in(key, i), j), n // px, cfg, samples=samples)))
        for j in range(sm)] for i in range(px)]


def _assert_budget(kind, samples, rad, plen, ref_rad, ref_plen):
    """The twin's flip rate per sample over ``samples`` a lane; on the
    other lanes the NIF's twin budget or the trace's tolerance."""
    flipped = plen != ref_plen
    assert flipped.mean() < FLIP_FRACTION * samples / TWIN_SAMPLES, \
        f"{flipped.sum()} flipped lanes"
    if kind == "nif":
        keep = ~flipped
        assert_matches_twin(rad[:, keep], plen[keep], ref_rad[:, keep], ref_plen[keep])
    else:
        np.testing.assert_allclose(rad[:, ~flipped], ref_rad[:, ~flipped], rtol=TRACE_RTOL,
                                   atol=TRACE_ATOL)


@pytest.mark.parametrize("shape,n", [("", 8), ("8x1", 8), ("4x2", 8), ("2x4", 8), ("1X8", 8),
                                     ("1x1", 1), ("3x2", 8), ("2", 8), ("2x2x2", 8)])
def test_parse_mesh_shape_matches_jax(shape, n):
    try:
        want = jmesh.parse_mesh_shape(shape, n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split("'")[0]):
            mesh.parse_mesh_shape(shape, n)
    else:
        assert mesh.parse_mesh_shape(shape, n) == want


def test_make_mesh_counts_and_reductions():
    m = mesh.make_mesh(8, "4x2", CPU8)
    assert m.shape == {"pixels": 4, "samples": 2} and m.size == 8 and m.reduction == "sum"
    assert mesh.make_mesh(8, "", CPU8).shape == {"pixels": 8, "samples": 1}
    assert mesh.make_mesh(1, "1x1", ["cpu"]).reduction == "none"
    with pytest.raises(ValueError, match="Requested 9 devices but only 8 available"):
        mesh.make_mesh(9, "", CPU8)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match=f"Requested 2 GPUs but only "
                                             f"{torch.cuda.device_count()} available"):
            mesh.make_mesh(2)


@pytest.mark.parametrize("shape,kind", [("8x1", "const"), ("4x2", "const"), ("2x4", "const"),
                                        ("8x1", "nif"), ("4x2", "nif"), ("2x4", "nif")])
def test_sharded_step_matches_jax(shape, kind):
    px, sm = mesh.parse_mesh_shape(shape, 8)
    jenv, env = _envs(kind)
    jm = jmesh.make_mesh(8, shape)
    jcfg = JStaticConfig(width=W, height=H, max_path_length=MAXLEN)
    key = jax.random.key(7)
    jwork = jto_device_batch(make_worklist(W, H))
    ref = jmesh.sharded_render_step(
        jmesh.replicate(jdefault_scene(), jm), JRenderSettings.make(samples_per_step=SPP), jcfg,
        jmesh.shard_work(jwork, jm), key, jmesh.replicate(jenv, jm), jm)
    m = mesh.make_mesh(8, shape, CPU8)
    work = to_device_batch(make_worklist(W, H), "cpu")
    out = mesh.gather_work(mesh.sharded_render_step(
        mesh.replicate(default_scene(), m), RenderSettings.make(samples_per_step=SPP),
        StaticConfig(width=W, height=H, max_path_length=MAXLEN), mesh.shard_work(work, m), None,
        mesh.replicate(env, m), m, noise=_jax_noise(key, (px, sm), work.u.shape[0], jcfg, SPP)))
    rad = torch.stack([out.r, out.g, out.b]).numpy()
    ref_rad = np.stack([np.asarray(ref.r), np.asarray(ref.g), np.asarray(ref.b)])
    plen, ref_plen = out.path_length.numpy(), np.asarray(ref.path_length)
    _assert_budget(kind, SPP * sm, rad, plen, ref_rad, ref_plen)
    assert (out.sample_count.numpy() == SPP * sm).all()
    np.testing.assert_array_equal(out.sample_count.numpy(), np.asarray(ref.sample_count))
    np.testing.assert_array_equal(out.u.numpy(), np.asarray(ref.u))


def _jax_megastep_twin(scene, settings, params, cols, rows, seed=None, *, noise, budgets,
                       with_stats, width, height, max_path_length, block_size, **_):
    """JAX's budgeted megastep with statistics as its reference
    composition (tests/test_megastep.py::_xla_twin): trace + nif_apply +
    bgr flip per sample, samples past a lane's block budget gated off."""
    from ipu_path_trace_tpu.ops.megastep_pallas import LUM_B, LUM_G, LUM_R, MegaStepOut
    from ipu_path_trace_tpu.render.wavefront import trace_sample_with_uniforms

    cfg = JStaticConfig(width=width, height=height, max_path_length=max_path_length)
    p = cols.shape[0]
    lane_budget = jnp.repeat(budgets, block_size)[:p]

    def sample(s, acc):
        rad, plen, lum2 = acc
        ns = noise[s]
        st = trace_sample_with_uniforms(scene, settings, cfg, cols, rows, ns[0:2], ns[2:4],
                                        ns[4:].reshape(max_path_length, 4, p))
        u, v = equirect_uv(st.esc_dir, settings.azimuth)
        out = nif_apply(params, jnp.where(st.escaped, u, 0.0), jnp.where(st.escaped, v, 0.0))
        c = jnp.stack([st.radiance.x + st.esc_w.x * out[:, 2],
                       st.radiance.y + st.esc_w.y * out[:, 1],
                       st.radiance.z + st.esc_w.z * out[:, 0]])
        on = s < lane_budget
        lum = LUM_R * c[0] + LUM_G * c[1] + LUM_B * c[2]
        return (rad + jnp.where(on, c, 0.0), plen + jnp.where(on, st.path_len, 0),
                lum2 + jnp.where(on, lum * lum, 0.0))

    zero = jnp.zeros(p, jnp.float32)
    rad, plen, lum2 = jax.lax.fori_loop(
        0, noise.shape[0], sample, (jnp.zeros((3, p), jnp.float32), jnp.zeros(p, jnp.int32), zero))
    return MegaStepOut(JVec3(rad[0], rad[1], rad[2]), plen, lum2)


def test_sharded_adaptive_step_matches_jax(monkeypatch):
    """Two adaptive steps on a 2x2 mesh: the same budgets (so the same
    sample counts), radiance and lum2 within the twin budget."""
    from ipu_path_trace_tpu.ops import megastep_pallas

    monkeypatch.setattr(megastep_pallas, "render_megastep_pallas", _jax_megastep_twin)
    shape, (px, sm) = "2x2", (2, 2)
    factor, amin = 2.0, 1
    jenv, env = _envs("nif")
    jm = jmesh.make_mesh(4, shape)
    jcfg = JStaticConfig(width=W, height=H, max_path_length=MAXLEN, pallas_interpret=SPP,
                         adaptive_min=amin, adaptive_max_factor=factor)
    cfg = StaticConfig(width=W, height=H, max_path_length=MAXLEN, adaptive_min=amin,
                       adaptive_max_factor=factor)
    cap = max(int(round(factor * SPP)), SPP)
    jsettings = JRenderSettings.make(samples_per_step=SPP)
    settings = RenderSettings.make(samples_per_step=SPP)
    m = mesh.make_mesh(4, shape, ["cpu"] * 4)
    jwork = jmesh.shard_work(jto_device_batch(make_worklist(W, H)), jm)
    jl2 = jmesh.shard_array(jnp.zeros(W * H, jnp.float32), jm)
    work = mesh.shard_work(to_device_batch(make_worklist(W, H), "cpu"), m)
    l2 = mesh.shard_array(torch.zeros(W * H), m)
    jscene, jenv_r = jmesh.replicate(jdefault_scene(), jm), jmesh.replicate(jenv, jm)
    scene_r, env_r = mesh.replicate(default_scene(), m), mesh.replicate(env, m)
    for step in (1, 2):
        key = jax.random.key(100 + step)
        jwork, jl2 = jmesh.sharded_adaptive_render_step(jscene, jsettings, jcfg, jwork, jl2, key,
                                                        jenv_r, jm)
        noise = _jax_noise(key, (px, sm), W * H, jcfg._replace(pallas_interpret=0), cap)
        work, l2 = mesh.sharded_adaptive_render_step(scene_r, settings, cfg, work, l2, None,
                                                     env_r, m, noise=noise, block_size=BLOCK)
    out, lum2 = mesh.gather_work(work), mesh.gather_work(l2)
    counts = out.sample_count.numpy()
    np.testing.assert_array_equal(counts, np.asarray(jwork.sample_count))
    assert counts.min() != counts.max()  # the second step's budgets varied
    rad = torch.stack([out.r, out.g, out.b]).numpy()
    ref_rad = np.stack([np.asarray(jwork.r), np.asarray(jwork.g), np.asarray(jwork.b)])
    plen, ref_plen = out.path_length.numpy(), np.asarray(jwork.path_length)
    samples = int(counts.max())
    _assert_budget("nif", samples, rad, plen, ref_rad, ref_plen)
    _assert_budget("nif", samples, np.sqrt(lum2.numpy())[None], plen,
                   np.sqrt(np.asarray(jl2))[None], ref_plen)


def test_image_mean_agrees_with_jax_sharded_render():
    """The port's Philox sharded render (4x2, 8 samples a replica) and
    JAX's sharded render agree in mean (independent streams: 5%, ~5
    sigma at 768 pixels x 16 samples, as tests/test_mesh.py)."""
    jm = jmesh.make_mesh(8, "4x2")
    jenv, env = _envs("const")
    ref = jmesh.sharded_render_step(
        jmesh.replicate(jdefault_scene(), jm), JRenderSettings.make(samples_per_step=8),
        JStaticConfig(width=W, height=H, max_path_length=MAXLEN),
        jmesh.shard_work(jto_device_batch(make_worklist(W, H)), jm), jax.random.key(3),
        jmesh.replicate(jenv, jm), jm)
    m = mesh.make_mesh(8, "4x2", CPU8)
    out = mesh.gather_work(mesh.sharded_render_step(
        default_scene(), RenderSettings.make(samples_per_step=8),
        StaticConfig(width=W, height=H, max_path_length=MAXLEN),
        to_device_batch(make_worklist(W, H), "cpu"), (3, 4), env, m))
    assert (out.sample_count == 16).all()
    m_port = float(out.r.sum()) / float(out.sample_count.sum())
    m_jax = float(np.asarray(ref.r).sum()) / float(np.asarray(ref.sample_count).sum())
    assert abs(m_port - m_jax) / m_jax < 0.05


@pytest.mark.parametrize("shape", ["8x1", "4x2", "2x4"])
@pytest.mark.parametrize("fused", [True, False])
def test_sharded_step_equals_its_replay(shape, fused):
    px, sm = mesh.parse_mesh_shape(shape, 8)
    m = mesh.make_mesh(8, shape, CPU8)
    env = _envs("nif")[1]
    cfg = StaticConfig(width=W, height=H, max_path_length=MAXLEN, use_fused_step=fused)
    settings = RenderSettings.make(samples_per_step=SPP)
    work = to_device_batch(make_worklist(W, H), "cpu")
    got = mesh.gather_work(mesh.sharded_render_step(default_scene(), settings, cfg,
                                                    mesh.shard_work(work, m), (11, 12), env, m))
    ref = replay(default_scene(), settings, cfg, work, (11, 12), env, (px, sm))
    res = compare(shape, got, ref, exact=sm == 1)
    assert res["ok"], res
    assert (got.sample_count == SPP * sm).all() and float(got.r.max()) > 0


def test_sharded_adaptive_step_equals_its_replay():
    m = mesh.make_mesh(4, "2x2", ["cpu"] * 4)
    env = _envs("nif")[1]
    cfg = StaticConfig(width=W, height=H, max_path_length=MAXLEN, adaptive_min=1,
                       adaptive_max_factor=2.0)
    settings = RenderSettings.make(samples_per_step=4)  # budgets 1 to 8: they vary
    work = to_device_batch(make_worklist(W, H), "cpu")
    lum2 = torch.zeros(W * H)
    sw, sl = work, lum2
    for step in (1, 2):
        sw, sl = mesh.sharded_adaptive_render_step(default_scene(), settings, cfg, sw, sl,
                                                   (5, step), env, m, block_size=BLOCK)
        work, lum2 = replay(default_scene(), settings, cfg, work, (5, step), env, (2, 2),
                            adaptive_lum2=lum2, block_size=BLOCK)
    counts = mesh.gather_work(sw).sample_count
    assert counts.min() != counts.max()  # the second step's budgets varied
    assert compare("2x2 adaptive", mesh.gather_work(sw), work, exact=False)["ok"]
    assert compare("2x2 lum2", mesh.gather_work(sl), lum2, exact=False)["ok"]


def test_padded_worklist_keeps_its_dummy_records():
    """10x7 = 70 pixels padded to 72 records on an 8x1 mesh: the dummies
    keep their DUMMY_COORD and the real records equal the replay."""
    m = mesh.make_mesh(8, "8x1", CPU8)
    wl = make_worklist(10, 7, padded_size=72)
    work = to_device_batch(wl, "cpu")
    cfg = StaticConfig(width=10, height=7, max_path_length=MAXLEN)
    settings = RenderSettings.make(samples_per_step=SPP)
    env = _envs("const")[1]
    got = mesh.gather_work(mesh.sharded_render_step(default_scene(), settings, cfg, work,
                                                    (1, 2), env, m))
    assert (got.u[70:] == 0xFFFF).all() and (got.v[70:] == 0xFFFF).all()
    np.testing.assert_array_equal(got.u.numpy(), wl["u"].astype(np.int32))
    ref = replay(default_scene(), settings, cfg, work, (1, 2), env, (8, 1))
    assert compare("10x7", got, ref, exact=True)["ok"]


def test_worklist_that_does_not_divide_raises():
    m = mesh.make_mesh(8, "8x1", CPU8)
    work = to_device_batch(make_worklist(10, 7), "cpu")  # 70 records
    with pytest.raises(ValueError, match="Worklist size 70 not divisible by pixel-axis size 8"):
        mesh.shard_work(work, m)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.sharded_render_step(default_scene(), RenderSettings.make(samples_per_step=1),
                                 StaticConfig(width=10, height=7, max_path_length=MAXLEN), work,
                                 (1, 2), ConstantEnv(COLOUR), m)


@pytest.mark.parametrize("film_base", [None, 6])
def test_sobol_replicas_draw_disjoint_slices(monkeypatch, film_base):
    """On a 1x4 mesh replica j draws each lane's Sobol points at base + j x
    spp (the device film's counts, or the host film's sobol_base): four
    disjoint slices of SPP points that tile [base, base + 4 SPP)."""
    bases = []
    real = megastep.render_megastep

    def spy(*a, sobol=None, **kw):
        bases.append(sobol[1].clone())
        return real(*a, sobol=sobol, **kw)

    monkeypatch.setattr(megastep, "render_megastep", spy)
    m = mesh.make_mesh(4, "1x4", ["cpu"] * 4)
    work = to_device_batch(make_worklist(W, H), "cpu")
    work = work._replace(sample_count=work.sample_count + 3)  # a device film after 3 samples
    cfg = StaticConfig(width=W, height=H, max_path_length=MAXLEN, sampler="sobol")
    mesh.sharded_render_step(default_scene(), RenderSettings.make(samples_per_step=SPP), cfg,
                             work, (8, 9), _envs("nif")[1], m, sobol_base=film_base)
    start = 3 if film_base is None else film_base
    assert len(bases) == 4
    for j, b in enumerate(bases):
        assert (b == start + j * SPP).all()
    drawn = sorted(int(b[0]) + s for b in bases for s in range(SPP))
    assert drawn == list(range(start, start + 4 * SPP))


def test_fold_seed_is_deterministic_and_distinct():
    seeds = {mesh.shard_seed((1, 2), i, j) for i in range(8) for j in range(8)}
    assert len(seeds) == 64
    assert mesh.shard_seed((1, 2), 3, 4) == mesh.fold_seed(mesh.fold_seed((1, 2), 3), 4)
    assert all(0 <= w < 1 << 32 for s in seeds for w in s)
    assert mesh.fold_seed((1, 2), 0) != (1, 2)


def test_replicate_shares_one_device_and_gather_restores_the_order():
    m = mesh.make_mesh(8, "4x2", CPU8)
    env = _envs("nif")[1]
    rep = mesh.replicate(env, m)
    assert rep.on("cpu") is env  # one device: no copy
    work = to_device_batch(make_worklist(W, H), "cpu")
    sw = mesh.shard_work(work, m)
    assert sw.parts[0][0] is sw.parts[0][1]  # replicas on one device share their slice
    back = mesh.gather_work(sw, "cpu")
    for a, b in zip(back, work):
        assert torch.equal(a, b)
    assert torch.equal(mesh.gather_work(mesh.shard_array(work.r, m)), work.r)
    fn = mesh.make_step_fn(StaticConfig(width=W, height=H, max_path_length=MAXLEN), m)
    out = fn(default_scene(), RenderSettings.make(samples_per_step=1), sw, (1, 1),
             ConstantEnv(COLOUR))
    assert isinstance(out, mesh.Sharded) and isinstance(mesh.gather_work(out), WorkBatch)
