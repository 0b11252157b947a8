"""The port's QAT fine-tune (models/quant.py: fake_quant_apply,
qat_finetune) and int8 ablation (probes/quant_ablation.py) against the
JAX package's and scripts/quant_ablation.py, on the CPU.

Tolerances, each stated where it is used:
* ``fake_quant_apply`` on the same features and weights: the forward to
  median 1e-6 relative and max 1e-4 of max |out| (the products round in
  another order, which can move a requantised activation across a tie -
  then a whole grid step - on a rare lane); the STE gradients of the same
  loss to 1e-3 of each layer's max |g| (a moved step changes the loss's
  slope on that lane only);
* the QAT smoke test mirrors tests/test_quant.py::test_qat_finetune_smoke
  (finite loss, one positive grid per hidden layer, shapes kept, every
  kernel moved, the result quantises and runs);
* ``selective_apply`` against the script's for all 8 flag combinations
  at 512 points, before the bgr -> rgb flip, on the same features (the
  script's ``nif_encode`` is given the port's encode): median 1e-6 and
  max 1e-4 relative to max |out| with no activation grid, and with one
  at most 1% of the lanes past 1e-4 (a tie moved by a product's rounding
  moves the lane by a grid step), none past 0.1;
* ``tools/quant_qat.main`` at a toy cut: its int8 PSNR equals, bit for
  bit, the gate's score of the asset it wrote, reloaded as the renderer
  loads it.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipu_path_trace_tpu.models import nif as jnif
from ipu_path_trace_tpu.models import quant as jquant
from ipu_path_trace_tpu_torch.models import nif, quant, synth_env
from ipu_path_trace_tpu_torch.probes import quant_ablation
from ipu_path_trace_tpu_torch.probes.quant_psnr import psnr_log, reconstruct_quant
from ipu_path_trace_tpu_torch.runtime.app import parse_env_assets
from ipu_path_trace_tpu_torch.tools import quant_qat

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite runs several workers on the
    same cores, and the trainer's many small ops, each split over every
    core, then wait on each other (a 300-step run took 20x longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_nif():
    """tests/test_quant.py's small_nif."""
    weights, meta = jnif.make_synthetic_nif(key=7, hidden=64, num_hidden=4, skip_layer=2)
    meta.log_tone_map = True
    return weights, meta


def _uv(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, n).astype(np.float32), rng.uniform(0, 1, n).astype(np.float32)


def _rel(got, ref):
    return np.abs(got - ref) / np.abs(ref).max()


def test_fake_quant_forward_and_ste_grads(small_nif):
    weights, meta = small_nif
    amax = tuple(jquant._f32_chain_activations(
        weights, jquant.calibration_features(meta.embedding_dimension, (64, 128))))
    u, v = _uv(600, 21)
    feats = np.array(jnif.fourier_features(jnp.asarray(u), jnp.asarray(v),
                                           meta.embedding_dimension))
    target = np.random.default_rng(4).normal(size=(600, 3)).astype(np.float32)
    jparams = [(jnp.asarray(l.kernel, jnp.float32), jnp.asarray(l.bias, jnp.float32))
               for l in weights.layers]
    import jax

    def jloss(params):
        out = jquant.fake_quant_apply(params, jnp.asarray(feats), 2, amax)
        return jnp.mean((out - target) ** 2), out

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tparams = [(torch.tensor(l.kernel, dtype=torch.float32, requires_grad=True),
                torch.tensor(l.bias, dtype=torch.float32, requires_grad=True))
               for l in weights.layers]
    out = quant.fake_quant_apply(tparams, torch.from_numpy(feats), 2, amax)
    torch.mean((out - torch.from_numpy(target)) ** 2).backward()
    ref = np.asarray(ref)
    rel = _rel(out.detach().numpy(), ref)
    # forward: median 1e-6 relative, max 1e-4 of max |out|
    assert np.median(np.abs(out.detach().numpy() - ref) / (np.abs(ref) + 1e-30)) < 1e-6
    assert rel.max() < 1e-4
    # STE gradients: 1e-3 of each layer's max |g|
    for (gw, gb), (w, b) in zip(jgrads, tparams):
        for g_ref, g in ((gw, w.grad), (gb, b.grad)):
            g_ref = np.asarray(g_ref)
            assert np.abs(g.numpy() - g_ref).max() <= 1e-3 * np.abs(g_ref).max()
    # the gradient is the identity's through every quantisation point
    assert all(w.grad is not None and bool(torch.isfinite(w.grad).all()) for w, _ in tparams)


def test_qat_finetune_smoke(small_nif, monkeypatch):
    """tests/test_quant.py::test_qat_finetune_smoke through the port."""
    jweights, jmeta = small_nif
    weights = nif.NifWeights([nif.NifLayer(l.name, l.kernel, l.bias, l.activation, l.dtype)
                              for l in jweights.layers])
    meta = nif.NifMetaData(jmeta.embedding_dimension, jmeta.name, jmeta.image_shape, jmeta.eps,
                           True, jmeta.max, jmeta.mean, jmeta.hidden_size)
    img = synth_env.resolve_synth("synth:urban-alley:64x128:seed3")
    new_w, amax, loss = quant.qat_finetune(weights, meta, img, epochs=2, batch_size=2048,
                                           train_samples=4096, calib_grid=(32, 64), seed=5,
                                           device="cpu")
    assert np.isfinite(loss)
    assert len(amax) == len(weights.layers) - 1 and all(a > 0 for a in amax)
    for old, new in zip(weights.layers, new_w.layers):
        assert new.kernel.shape == old.kernel.shape and new.name == old.name
        assert not np.array_equal(new.kernel, old.kernel)
    assert quant.skip_from_shapes(new_w) == 2
    qm = quant.quantize_nif(new_w, meta, amax=amax)
    u, v = _uv(128, 1)
    assert torch.isfinite(quant.nif_apply_quant(qm, torch.from_numpy(u),
                                                torch.from_numpy(v))).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        quant.qat_finetune(weights, meta, img, epochs=1, batch_size=2048)


def _script(name):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(f"script_{name}", ROOT / "scripts" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ABLATION = _script("quant_ablation.py")
FLAGS = [dict(q_feats=f, q_weights=w, q_acts=a)
         for f in (False, True) for w in (False, True) for a in (False, True)]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(k[2:] for k, v in f.items() if v)
                         or "f32")
def test_selective_apply_matches_script(monkeypatch, flags):
    jweights, jmeta = jnif.make_synthetic_nif(key=9, hidden=48, num_hidden=4, skip_layer=2,
                                              embedding_dim=6)
    weights = nif.NifWeights([nif.NifLayer(l.name, l.kernel, l.bias, l.activation, l.dtype)
                              for l in jweights.layers])
    meta = nif.NifMetaData(jmeta.embedding_dimension, jmeta.name, jmeta.image_shape, jmeta.eps,
                           jmeta.log_tone_map, jmeta.max, jmeta.mean, jmeta.hidden_size)
    amax = quant._f32_chain_activations(weights, quant.calibration_features(6, (32, 64)))
    u, v = _uv(512, 8)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    # the script encodes with the TPU kernel's recurrence; give it the port's encode
    feats_t = nif.fourier_features(tu, tv, 6).numpy().T.copy()
    monkeypatch.setattr(ABLATION, "nif_encode", lambda *a, **k: jnp.asarray(feats_t))
    ref = np.asarray(ABLATION.selective_apply(jweights, jmeta, jnp.asarray(u), jnp.asarray(v),
                                              amax=amax, **flags))
    got = quant_ablation.selective_apply(weights, meta, tu, tv, amax=amax, **flags).numpy()
    assert got.shape == ref.shape == (512, 3)
    rel = _rel(got, ref)
    if not flags["q_acts"]:
        assert np.median(rel) < 1e-6 and rel.max() < 1e-4
    else:
        assert np.median(rel) < 1e-6 and (rel > 1e-4).mean() <= 0.01 and rel.max() < 0.1


def test_ablation_cli_cpu(capsys):
    out = quant_ablation.main(["--device", "cpu", "--env", "synth:urban-alley:64x128:seed7",
                               "--eval-grid", "32x64", "--grid", "16x32"])
    assert set(out) >= {f"{k}_psnr_db" for k in quant_ablation.CASES}
    assert all(np.isfinite(out[f"{k}_psnr_db"]) for k in quant_ablation.CASES)
    assert capsys.readouterr().out.strip().startswith("{")


@pytest.mark.parametrize("keep", [True, False], ids=["out", "no-out"])
def test_quant_qat_cli_cpu(tmp_path, capsys, monkeypatch, keep):
    """tools/quant_qat.main at a toy cut: the printed entry scores the asset
    as the renderer loads it (the f16 weights it stores, quantised with
    its quant_amax.json), bit for bit; without --out nothing is left."""
    made = []
    mkdtemp = quant_qat.tempfile.mkdtemp
    monkeypatch.setattr(quant_qat.tempfile, "mkdtemp",
                        lambda **k: made.append(mkdtemp(dir=tmp_path, **k)) or made[-1])
    env = "synth:urban-alley:32x64:seed7"
    out = tmp_path / "qat"
    argv = ["--env", env, "--epochs", "1", "--batch-size", "512", "--train-samples", "1024",
            "--grid", "16x32", "--max-batch", "4096", "--device", "cpu"]
    entry = quant_qat.main([*argv, "--out", str(out)] if keep else argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == entry
    assert entry["steps"] == 2 and np.isfinite(entry["final_loss"])
    assert np.isfinite(entry["int8_psnr_db"]) and np.isfinite(entry["int8_psnr_recalibrated_db"])
    if not keep:
        assert "out" not in entry and len(made) == 1 and not Path(made[0]).exists()
        return
    assert entry["out"] == str(out) and not made
    with open(out / "quant_amax.json") as f:
        sidecar = json.load(f)
    assert sidecar == {"amax": entry["amax"], "calibration_grid": "16x32"}
    _, meta, weights = nif.load_nif_assets(str(out))
    assert all(l.kernel.dtype == np.float16 for l in weights.layers)
    model = parse_env_assets(str(out), torch.device("cpu"), "int8")[0].model
    src = synth_env.resolve_synth(env)
    assert psnr_log(reconstruct_quant(model, 32, 64, 4096), src) == entry["int8_psnr_db"]
