"""The reconstruct tool and the on-class quality gate of the PyTorch port
(models/synth_env.py, models/reconstruct.py, probes/quant_psnr.py)
against the JAX package and the script they port (scripts/quant_psnr.py).

* the synthetic env equals the JAX generator bit for bit;
* reconstruct_image splits the grid into the same batches as the JAX
  one and agrees with it within the NIF budget: bf16 median 5e-3 and max
  8e-2 relative error floored at 1% of the peak (tests/test_nif_pallas.py);
  the int8 frame against the script's reconstruct_quant with the
  reference's int8 budget (median 1e-3, fewer than 1% of lanes above
  1e-2, max 0.5: the script encodes by the double-angle recurrence, the
  port by the direct sin/cos, so a feature next to a rounding tie may
  take a neighbouring int8 code; tests/test_quant.py);
* psnr_log equals the script's, and the gate's two PSNRs match the JAX
  pipeline's within 0.05 dB at 64x128.
"""

import importlib.util
import logging
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipu_path_trace_tpu.models import nif as jnif
from ipu_path_trace_tpu.models import quant as jquant
from ipu_path_trace_tpu.models import reconstruct as jrec
from ipu_path_trace_tpu.models import synth_env as jsynth
from ipu_path_trace_tpu_torch.film.imageio import read_exr
from ipu_path_trace_tpu_torch.models import nif, quant, reconstruct, synth_env
from ipu_path_trace_tpu_torch.ops import nif as nif_ops
from ipu_path_trace_tpu_torch.probes import quant_psnr

ROOT = Path(__file__).resolve().parents[1]
ASSET = str(ROOT / "assets" / "urban_alley_synth_nif")
ENV = "synth:urban-alley:64x128:seed7"
H, W = 64, 128


def _script(name):
    """A module of scripts/ (they import the JAX package from the root)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(f"script_{name}", ROOT / "scripts" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


QPSNR = _script("quant_psnr.py")


def _rel(got, ref):
    return np.abs(got - ref) / (np.abs(ref) + 1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("seed", [7, 11])
def test_synth_env_matches_jax(seed):
    got = synth_env.make_urban_env(48, 96, seed)
    ref = jsynth.make_urban_env(48, 96, seed)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(synth_env.resolve_synth(f"synth:urban-alley:48x96:seed{seed}"),
                                  ref)


def test_resolve_synth_scheme():
    assert synth_env.resolve_synth("assets/procedural_sky.exr") is None
    with pytest.raises(ValueError, match="unknown synth env scheme"):
        synth_env.resolve_synth("synth:beach:64x128:seed1")


def test_uv_grid_and_batch_split_match_jax():
    for a, b in zip(reconstruct.uv_grid(H, W), jrec.uv_grid(H, W)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for n, cap in ((H * W, 3000), (H * W, H * W), (8 * 1024 * 1024, 1 << 19), (7, 2), (97, 10)):
        factor, batch = reconstruct.batch_split(n, cap)
        assert factor * batch == n and batch <= cap
        assert all(n % f for f in range(max(1, -(-n // cap)), factor))  # the smallest


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_reconstruct_matches_jax(monkeypatch):
    """The same batches (the JAX tool logs its split; the port's calls are
    counted) and the same frame within the bf16 budget."""
    jparams, _, _ = jnif.load_nif_assets(ASSET, jnp.bfloat16)
    model, _, _ = nif.load_nif_assets(ASSET, torch.bfloat16)
    records = _Records()
    jlog = logging.getLogger("ipu_path_trace_tpu")
    jlog.addHandler(records)
    try:
        ref = jrec.reconstruct_image(jparams, H, W, max_batch_size=3000)
    finally:
        jlog.removeHandler(records)
    (split,) = [m for m in records.messages if m.startswith("Batch-size serialisation")]
    sizes = []
    apply = reconstruct.nif_apply_t
    monkeypatch.setattr(reconstruct, "nif_apply_t",
                        lambda m, u, v: sizes.append(u.shape[0]) or apply(m, u, v))
    got = reconstruct.reconstruct_image(model, H, W, max_batch_size=3000)
    assert split.endswith(f"serial-size: {sizes[0]} factor: {len(sizes)}")
    assert sizes == [H * W // 4] * 4
    assert got.shape == ref.shape == (H, W, 3) and got.dtype == np.float32
    rel = _rel(got, ref)
    assert np.median(rel) < 5e-3 and rel.max() < 8e-2, (np.median(rel), rel.max())
    # The flip: rgb out, the network's bgr in.
    raw = reconstruct.reconstruct_image(model, H, W, max_batch_size=3000, reverse_channels=False)
    np.testing.assert_array_equal(raw[..., ::-1], got)


def test_reconstruct_quant_matches_script():
    _, meta, weights = jnif.load_nif_assets(ASSET, jnp.bfloat16)
    amax = jquant._f32_chain_activations(
        weights, jquant.calibration_features(meta.embedding_dimension, (32, 64)))
    qmodel = quant.quantize_nif(weights, meta, amax=amax)
    calls = nif_ops.nif_apply_t_plain.cuda_runs
    got = quant_psnr.reconstruct_quant(qmodel, H, W, 3000)
    ref = QPSNR.reconstruct_quant(jquant.quantize_nif(weights, meta, amax=amax), H, W, 3000)
    assert nif_ops.nif_apply_t_plain.cuda_runs == calls  # CPU tensors: no CUDA run
    assert got.shape == ref.shape == (H, W, 3)
    rel = _rel(got, ref)
    assert np.median(rel) < 1e-3 and (rel > 1e-2).mean() < 0.01 and rel.max() < 0.5, (
        np.median(rel), (rel > 1e-2).mean(), rel.max())


def test_psnr_log_matches_the_sweep():
    sweep = _script("nif_width_sweep.py")
    rng = np.random.default_rng(4)
    ref = rng.lognormal(0.0, 2.0, (16, 32, 3)).astype(np.float32)
    img = (ref * rng.uniform(0.8, 1.2, ref.shape)).astype(np.float32)
    img[0, 0, 0] = -1.0  # clamped to 0 before the log
    assert quant_psnr.psnr_log(img, ref) == sweep.psnr_log(img, ref)


def test_quality_gate_matches_jax_pipeline(capsys):
    """The gate end to end at 64x128 on the CPU (plain versions) against
    the script's pipeline on the JAX package: the same PTQ scheme (the
    calibration encodes differ: direct sin/cos against the double-angle
    recurrence) and the same PSNR, within 0.05 dB."""
    got = quant_psnr.main(["--env", ENV, "--grid", "32x64", "--max-batch", "3000",
                           "--device", "cpu", "--assets", ASSET])
    assert capsys.readouterr().out.strip().endswith("}")
    src = jsynth.resolve_synth(ENV)
    jparams, meta, weights = jnif.load_nif_assets(ASSET, jnp.bfloat16)
    p_bf16 = QPSNR.psnr_log(jrec.reconstruct_image(jparams, H, W, max_batch_size=3000), src)
    qp = jquant.quantize_nif(weights, meta, grid=(32, 64))
    p_q = QPSNR.psnr_log(QPSNR.reconstruct_quant(qp, H, W, 3000), src)
    assert got["env"] == ENV and got["calibration_grid"] == "32x64"
    assert got["device"] == "cpu, plain versions"
    assert abs(got["bf16_psnr_db"] - p_bf16) < 0.05, (got, p_bf16)
    assert abs(got["int8_psnr_db"] - p_q) < 0.05, (got, p_q)


def test_reconstruct_cli_cpu(tmp_path):
    out = tmp_path / "env.exr"
    assert reconstruct.main([ASSET, str(out), str(H), str(W), "--max-batch-size", "3000",
                             "--device", "cpu"]) == 0
    model, _, _ = nif.load_nif_assets(ASSET, torch.bfloat16)
    np.testing.assert_array_equal(read_exr(str(out)),
                                  reconstruct.reconstruct_image(model, H, W, 3000))
    png = tmp_path / "env.png"
    assert reconstruct.main([ASSET, str(png), "16", "32", "--device", "cpu"]) == 0
    assert png.read_bytes().startswith(b"\x89PNG")


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the check is for hosts without one")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        reconstruct.main([ASSET, str(tmp_path / "env.exr")])
    with pytest.raises(SystemExit, match="CUDA is not available"):
        quant_psnr.main([])
