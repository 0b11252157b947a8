"""The port's NumPy oracle (ipu_path_trace_tpu_torch/cpu/oracle.py) and
its accuracy acceptance (probes/validate_rmse.py) on the CPU.

(i) The port's oracle is the JAX package's twin: on the same numpy
streams and the same scene it returns the same radiance and path lengths
to the last bit, for a constant, texture and NIF env and with the thin
lens.  (ii) The port's plain ``render_step`` in host-noise mode against
the port's oracle on the same noise at 24x24, 4 spp, with the JAX
package's own parity tolerances (tests/test_oracle_parity.py): a few
lanes may flip a float32 knife edge; the rest agree to rounding.  (iii)
The port's ``validate_rmse.run_config`` passes each config's criterion at
32x32 on the CPU (its plain versions; the card runs the kernels).
"""

import os

import numpy as np
import pytest
import torch

from ipu_path_trace_tpu.core import scene as jscene_mod
from ipu_path_trace_tpu.core.scenefile import load_scene as jload_scene
from ipu_path_trace_tpu.cpu import oracle as joracle
from ipu_path_trace_tpu.models import nif as jnif
from ipu_path_trace_tpu_torch.core.records import make_worklist, to_device_batch
from ipu_path_trace_tpu_torch.core.scene import Material, Scene, default_scene, make_scene
from ipu_path_trace_tpu_torch.cpu import oracle
from ipu_path_trace_tpu_torch.models import nif
from ipu_path_trace_tpu_torch.models.envlight import ConstantEnv, NifEnv, TextureEnv
from ipu_path_trace_tpu_torch.probes import validate_rmse
from ipu_path_trace_tpu_torch.render.params import RenderSettings, StaticConfig
from ipu_path_trace_tpu_torch.render.wavefront import render_step, trace_sample_with_uniforms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 24
L = 10
SETTINGS = validate_rmse.SETTINGS  # tests/test_oracle_parity.py's



@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the suite runs files side by side in workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _port_scene(jscene) -> Scene:
    """A JAX package Scene as the port's (same fields, same values)."""
    return Scene(*(torch.from_numpy(np.array(x)) for x in jscene))


def _noise(rng, spp, p, max_path=L) -> np.ndarray:
    """(S, 4 + 4L, P) host noise in the kernels' layout: distributed AA
    jitter, then uniforms."""
    noise = rng.uniform(0.0, 1.0, (spp, 4 + 4 * max_path, p)).astype(np.float32)
    noise[:, 0:2] = rng.normal(size=(spp, 2, p))
    return noise


def _trace_kwargs(max_path=L):
    return dict(fov=SETTINGS["fov"], aa_scale=SETTINGS["aa_scale"], azimuth=SETTINGS["azimuth"],
                refractive_index=SETTINGS["refractive_index"], stop_prob=SETTINGS["stop_prob"],
                roulette_depth=SETTINGS["roulette_depth"], max_path_length=max_path)


def _nif_weights():
    """A small JAX-made NIF (6 x 64, E = 6, skip at 3) and the port's
    NifWeights / NifMetaData of the same values."""
    jw, jm = jnif.make_synthetic_nif(key=5, hidden=64, num_hidden=3, embedding_dim=6,
                                     skip_layer=1)
    pw = nif.NifWeights([nif.NifLayer(name=l.name, kernel=l.kernel, bias=l.bias,
                                      activation=l.activation, dtype=l.dtype)
                         for l in jw.layers])
    pm = nif.NifMetaData(embedding_dimension=jm.embedding_dimension, name=jm.name,
                         image_shape=jm.image_shape, eps=jm.eps, log_tone_map=jm.log_tone_map,
                         max=jm.max, mean=np.asarray(jm.mean, np.float32),
                         hidden_size=jm.hidden_size)
    return (jw, jm), (pw, pm)


def _envs():
    rng = np.random.default_rng(3)
    tex = (rng.random((32, 64, 3)) * 2.0).astype(np.float32)
    (jw, jm), (pw, pm) = _nif_weights()
    c = np.asarray([1.0, 0.8, 0.6], np.float32)
    return {"constant": (("constant", c), ("constant", c)),
            "texture": (("texture", tex), ("texture", tex)),
            "nif": (("nif", jw, jm), ("nif", pw, pm))}


@pytest.mark.parametrize("env", ["constant", "texture", "nif", "dof"])
def test_oracle_equals_the_jax_oracle(env):
    """Same streams, same scene: bit for bit the JAX package's oracle."""
    jscene = jscene_mod.default_scene()
    oj = joracle.oracle_scene_from(jscene)
    op = oracle.oracle_scene_from(_port_scene(jscene))
    for f in ("sphere_center", "sphere_radius", "disc_normal", "disc_center", "disc_radius",
              "colour", "emission", "material"):
        a, b = getattr(oj, f), getattr(op, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    wl = make_worklist(W, H)
    cols, rows = wl["u"].astype(np.float32), wl["v"].astype(np.float32)
    noise = _noise(np.random.default_rng(21), 1, cols.size)[0]
    aa, lens, uniforms = oracle.oracle_streams(noise)
    assert aa.shape == (2, W * H) and lens.shape == (2, W * H) and uniforms.shape == (L, 4, W * H)
    np.testing.assert_array_equal(uniforms[3, 2], noise[4 + 4 * 3 + 2])
    jenv, penv = _envs()["constant" if env == "dof" else env]
    extra = dict(lens=lens, aperture=0.25, focal_distance=3.0) if env == "dof" else {}
    rj, pj = joracle.trace_sample_oracle(oj, cols, rows, W, H, aa=aa, uniforms=uniforms,
                                         env=jenv, **_trace_kwargs(), **extra)
    rp, pp = oracle.trace_sample_oracle(op, cols, rows, W, H, aa=aa, uniforms=uniforms,
                                        env=penv, **_trace_kwargs(), **extra)
    assert rj.dtype == rp.dtype == np.float32
    np.testing.assert_array_equal(rp, rj)
    np.testing.assert_array_equal(pp, pj)
    assert rp.mean() > 0.01


def _settings(spp, **kw):
    return RenderSettings.make(samples_per_step=spp, env_rotation_degrees=0.0, **kw)._replace(
        fov=float(SETTINGS["fov"]), aa_scale=float(SETTINGS["aa_scale"]),
        azimuth=float(SETTINGS["azimuth"]))


def _run_pair(env_port, env_oracle, scene, spp=4, seed=7):
    """The port's plain render_step in host-noise mode and the oracle on
    the same noise -> two (H, W, 3) mean images."""
    noise = _noise(np.random.default_rng(seed), spp, W * H)
    cfg = StaticConfig(width=W, height=H, max_path_length=L)
    work = to_device_batch(make_worklist(W, H), "cpu")
    out = render_step(scene, _settings(spp), cfg, work, None, env_port,
                      noise=torch.from_numpy(noise))
    img = (torch.stack([out.r, out.g, out.b], -1).numpy() / spp).reshape(H, W, 3)
    assert (out.sample_count == spp).all()
    wl = make_worklist(W, H)
    cols, rows = wl["u"].astype(np.float32), wl["v"].astype(np.float32)
    oscene = oracle.oracle_scene_from(scene)
    acc = np.zeros((W * H, 3), np.float32)
    for s in range(spp):
        aa, _, uniforms = oracle.oracle_streams(noise[s])
        acc += oracle.trace_sample_oracle(oscene, cols, rows, W, H, aa=aa, uniforms=uniforms,
                                          env=env_oracle, **_trace_kwargs())[0]
    return img, (acc / spp).reshape(H, W, 3)


def _assert_parity(img, ref, *, scale=1.0, max_diverged=0.05, tol=2e-4):
    """tests/test_oracle_parity.py::_assert_parity."""
    diff = np.abs(img - ref).max(axis=-1) / scale
    diverged = diff > 1e-2
    frac = float(diverged.mean())
    assert frac < max_diverged, f"diverged fraction {frac}"
    agree_rmse = float(np.sqrt(np.mean(diff[~diverged] ** 2)))
    assert agree_rmse < tol, f"agreeing-lane RMSE {agree_rmse}"


def _diffuse_scene():
    M = Material
    return make_scene(spheres=[((-1.0, 0.0, -4.0), 0.8), ((1.2, 0.2, -5.0), 1.0)],
                      discs=[((0.0, 1.0, 0.0), (0.0, -1.6, -5.0), 4.0)],
                      colours=[(1.5, 0.5, 0.5), (0.5, 1.5, 0.5), (1.0, 1.0, 1.0)],
                      emissions=[(0, 0, 0)] * 3, materials=[M.DIFFUSE] * 3)


@pytest.mark.parametrize("case", ["constant", "emissive", "texture", "nif_f32", "diffuse",
                                  "grid"])
def test_plain_render_step_matches_the_oracle(case):
    c = (1.0, 0.8, 0.6)
    env_port, env_oracle, scene = ConstantEnv(colour=c), ("constant", np.asarray(c, np.float32)), \
        default_scene()
    spp, check = 4, {}
    if case == "emissive":
        scene = _port_scene(jload_scene(os.path.join(REPO, "assets/scenes/three_spheres.json")))
        dark = (0.01, 0.01, 0.015)
        env_port, env_oracle = ConstantEnv(colour=dark), ("constant", np.asarray(dark, np.float32))
    elif case == "texture":
        tex = (np.random.default_rng(3).random((32, 64, 3)) * 2.0).astype(np.float32)
        env_port, env_oracle = TextureEnv(texture=torch.from_numpy(tex)), ("texture", tex)
    elif case == "nif_f32":
        _, (pw, pm) = _nif_weights()
        env_port = NifEnv(model=nif.make_params(pw, pm, torch.float32))
        env_oracle, spp = ("nif", pw, pm), 2
    elif case == "diffuse":
        scene, check = _diffuse_scene(), dict(max_diverged=0.005, tol=1e-4)
        env_port, env_oracle = ConstantEnv(colour=(1.0, 1.0, 1.0)), ("constant", np.ones(3, np.float32))
    elif case == "grid":
        scene, spp = _port_scene(jscene_mod.grid_scene(23)), 2
        assert scene.num_objects == 24
        g = (0.6, 0.7, 0.9)
        env_port, env_oracle = ConstantEnv(colour=g), ("constant", np.asarray(g, np.float32))
    img, ref = _run_pair(env_port, env_oracle, scene, spp)
    scale = 1.0 if case in ("constant", "texture", "diffuse") else max(1.0, float(ref.max()))
    _assert_parity(img, ref, scale=scale, **check)
    assert img.mean() > 0.01
    if case == "emissive":
        assert img.max() > 0.5  # the ball light lights the frame


def test_plain_trace_dof_matches_the_oracle():
    """Thin lens: the plain trace with injected uniforms and lens noise
    against the oracle, pre-env radiance plus the escape weights (a
    constant env of ones), the JAX test's tolerances."""
    scene = default_scene()
    settings = RenderSettings.make(samples_per_step=1, aperture=0.25, focal_distance=3.0)
    cfg = StaticConfig(width=W, height=H, max_path_length=6)
    wl = make_worklist(W, H)
    cols, rows = wl["u"].astype(np.float32), wl["v"].astype(np.float32)
    aa, lens, uniforms = oracle.oracle_streams(_noise(np.random.default_rng(21), 1, W * H, 6)[0])
    st = trace_sample_with_uniforms(scene, settings, cfg, torch.from_numpy(cols),
                                    torch.from_numpy(rows), torch.from_numpy(aa),
                                    torch.from_numpy(lens), torch.from_numpy(uniforms))
    rad_o, _ = oracle.trace_sample_oracle(
        oracle.oracle_scene_from(scene), cols, rows, W, H, fov=settings.fov,
        aa_scale=settings.aa_scale, azimuth=0.0, refractive_index=1.5, stop_prob=0.3,
        roulette_depth=3, max_path_length=6, aa=aa, uniforms=uniforms,
        env=("constant", np.ones(3, np.float32)), lens=lens, aperture=0.25, focal_distance=3.0)
    rad = (st.radiance.stack() + st.esc_w.stack()).t().numpy()
    diff = np.abs(rad - rad_o).max(axis=-1)
    assert float((diff > 1e-2).mean()) < 0.02
    assert float(np.sqrt(np.mean(np.minimum(diff, 1e-2) ** 2))) < 1e-3


@pytest.mark.parametrize("name, path", [(n, p) for n in validate_rmse.CONFIGS
                                        for p in validate_rmse.paths(n)])
def test_validate_rmse_config_passes_on_the_cpu(name, path):
    """The accuracy acceptance's pipeline at 32x32 (spp and criterion
    kept), rendered with the plain versions."""
    entry = validate_rmse.run_config(name, size_override=(32, 32), device="cpu", path=path)
    assert entry["pass"], entry
    assert (entry["width"], entry["spp"], entry["path"]) == (32, validate_rmse.CONFIGS[name][2],
                                                             path)
    assert entry["device"] == "cpu, plain versions"
