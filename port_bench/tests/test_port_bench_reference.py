"""The frozen plain reference against the renderer's plain versions, on the
CPU at tiny sizes: the same noise, paths, NIF outputs, megastep sums,
budgets, worklist order and seeds.  (The reference imports nothing of the
renderer; this test imports both.)"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from ipu_path_trace_tpu_torch.core.records import make_worklist  # noqa: E402
from ipu_path_trace_tpu_torch.core.scene import default_scene as port_scene  # noqa: E402
from ipu_path_trace_tpu_torch.models.nif import load_nif_assets, nif_apply  # noqa: E402
from ipu_path_trace_tpu_torch.ops.megastep import render_megastep_plain  # noqa: E402
from ipu_path_trace_tpu_torch.ops.trace import philox_noise, trace_sample_plain  # noqa: E402
from ipu_path_trace_tpu_torch.parallel.mesh import shard_seed as port_shard_seed  # noqa: E402
from ipu_path_trace_tpu_torch.render import adaptive as port_adaptive  # noqa: E402
from ipu_path_trace_tpu_torch.render.params import RenderSettings  # noqa: E402
from ipu_path_trace_tpu_torch.runtime.app import step_seed  # noqa: E402
from ipu_path_trace_tpu_torch.runtime.worklist import coherent_order, create_tracing_jobs  # noqa: E402

from port_bench.reference import budgets, geometry, nif, replay, trace, worklist  # noqa: E402

W, H, L = 24, 16, 10
SEED = (0x12345678, 0x9ABCDEF0)
ALLEY = str(ROOT / "assets" / "urban_alley_synth_nif")


def lanes(n=W * H):
    px = torch.arange(n, dtype=torch.int64)
    return px, (px % W).to(torch.float32), (px // W).to(torch.float32)


def test_noise_rows_are_the_renderers():
    px, _, _ = lanes()
    for s in (0, 3):
        ref = trace.noise_rows(SEED, px, torch.full_like(px, s), L, "normal")
        assert torch.equal(ref, philox_noise(SEED, s, len(px), L, "normal", "cpu"))


@pytest.mark.parametrize("sample", [0, 5])
def test_paths_are_the_renderers_bit_for_bit(sample):
    px, cols, rows = lanes()
    st = trace.Settings.make(W, H)
    ref = trace.trace_paths(geometry.default_scene(), st, cols, rows,
                            trace.noise_rows(SEED, px, torch.full_like(px, sample), L, "normal"))
    got = trace_sample_plain(port_scene(), RenderSettings.make(), cols, rows, SEED,
                             sample_index=sample, width=W, height=H, max_path_length=L)
    for a, b in zip(ref.esc_dir + ref.esc_w + ref.radiance, got.esc_dir + got.esc_w + got.radiance):
        assert torch.equal(a, b)
    assert torch.equal(ref.path_len, got.path_len)
    assert torch.equal(ref.escaped, got.escaped)


@pytest.mark.parametrize("asset", ["urban_alley_synth_nif", "nif_w192e16"])
def test_nif_is_the_renderers_bf16_chain(asset):
    path = str(ROOT / "assets" / asset)
    model, _, _ = load_nif_assets(path, torch.bfloat16, "cpu")
    ref = nif.load_nif(path)
    g = torch.Generator().manual_seed(3)
    u, v = torch.rand(257, generator=g), torch.rand(257, generator=g)
    want = nif_apply(model, u, v)
    got = nif.nif_apply(ref, u, v)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    assert ref.widths() == [list(k.shape) for k in model.kernels]


def test_fp8_control_departs_from_bf16():
    ref, ctl = nif.load_nif(ALLEY), nif.load_nif(ALLEY, "fp8")
    g = torch.Generator().manual_seed(4)
    u, v = torch.rand(4096, generator=g), torch.rand(4096, generator=g)
    a, b = nif.nif_apply(ref, u, v), nif.nif_apply(ctl, u, v, "fp8")
    assert float((a - b).abs().sum() / a.abs().sum()) > 1e-2


def test_replay_sums_are_the_megasteps():
    """Two steps of 3 samples over every record against the renderer's
    plain megastep fed the same seeds."""
    scene, model = port_scene(), load_nif_assets(ALLEY, torch.bfloat16, "cpu")[0]
    px, cols, rows = lanes()
    settings = RenderSettings.make(samples_per_step=3)
    seeds = [SEED, (7, 11)]
    want_r, want_p = torch.zeros(len(px)), torch.zeros(len(px), dtype=torch.int32)
    for s in seeds:
        out = render_megastep_plain(scene, settings, model, cols, rows, s, width=W, height=H,
                                    max_path_length=L)
        want_r, want_p = want_r + out.radiance.x, want_p + out.path_len
    got = replay.replay(geometry.default_scene(), trace.Settings.make(W, H), nif.load_nif(ALLEY),
                        px.numpy(), cols.numpy(), rows.numpy(), seeds,
                        replay.Layout(False, 1, 1, len(px)), 3)
    assert np.allclose(got.r, want_r.numpy(), rtol=1e-5, atol=1e-6)
    assert np.array_equal(got.path_length, want_p.numpy())
    assert np.array_equal(got.sample_count, np.full(len(px), 6))


def test_budgets_are_the_controllers():
    g = torch.Generator().manual_seed(5)
    n = 5000
    r, gg, b = (torch.rand(n, generator=g) * 4 for _ in range(3))
    lum2 = torch.rand(n, generator=g) * 20
    count = torch.randint(1, 64, (n,), generator=g, dtype=torch.int32)
    kw = dict(block_size=2048, samples_per_step=16, min_spp=2, max_spp=64)
    assert torch.equal(budgets.compute_budgets(r, gg, b, lum2, count, **kw),
                       port_adaptive.compute_budgets(r, gg, b, lum2, count, **kw))
    assert budgets.adaptive_caps(8, 16.0, 128) == port_adaptive.adaptive_caps(
        port_adaptive.StaticConfig(adaptive_min=8, adaptive_max_factor=16.0), 128)


@pytest.mark.parametrize("shards", [1, 4])
def test_coherent_order_is_the_renderers(shards):
    wl = coherent_order(create_tracing_jobs(W, H, multiple_of=shards), port_scene(), W, H, 90.0,
                        shards=shards)
    u, v = worklist.coherent_worklist(geometry.default_scene(), W, H, 90.0, shards)
    assert np.array_equal(u, wl["u"].astype(np.int64))
    assert np.array_equal(v, wl["v"].astype(np.int64))
    assert worklist.worklist_size(1104, 1000) == len(make_worklist(1104, 1000)) == 1104000


def test_seeds_are_the_apps():
    gen = torch.Generator().manual_seed(2**31 + 99)
    assert trace.step_seeds(2**31 + 99, 3) == [step_seed(gen) for _ in range(3)]
    for i, j in ((0, 0), (3, 0), (1, 2)):
        assert trace.shard_seed(SEED, i, j) == port_shard_seed(SEED, i, j)
