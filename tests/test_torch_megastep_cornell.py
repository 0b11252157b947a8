"""K3 on the smallpt Cornell box (assets/scenes/cornell_smallpt.json), on
the card: deep paths (glass, mirror, ten bounces) through the kernel, and
its trace counters.

    python -m pytest --noconftest tests/test_torch_megastep_cornell.py -m card -s

At 128x96 with 8 Philox samples and the alley NIF: the kernel against its
plain version (path lengths bit for bit, radiance within chip_smoke's bf16
limits); traced and untraced launches bit-identical; every block's
record written, its trace time within its run time, its bounces within
the lane-iterations its warps held, and, over the launch, the bounces
between the path-length sum (every push is a bounce) and that sum plus
one roulette kill a lane-sample.
"""

import pytest
import torch

from ipu_path_trace_tpu_torch.ops import megastep
from ipu_path_trace_tpu_torch.ops.megastep import RAYS_PER_CUDA_BLOCK

SCENE = "assets/scenes/cornell_smallpt.json"
NIF = "assets/urban_alley_synth_nif"
FOV = 37.79556976963653  # port_bench/configs/cornell_smallpt.json
W, H, SPP, L = 128, 96, 8, 10
# chip_smoke.py::mode_check's limits for the bf16 chain against its plain
# version (as tests/test_torch_megastep_order.py).
NIF_MEDIAN, NIF_MAX = 5e-3, 8e-2
NIF_TAIL_FRACTION, NIF_TAIL_MAX = 1e-4, 0.25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda")


def _launch(dev, plain=False, **kw):
    from ipu_path_trace_tpu_torch.core.scenefile import load_scene
    from ipu_path_trace_tpu_torch.render.params import RenderSettings
    from ipu_path_trace_tpu_torch.runtime.app import parse_env_assets

    model = parse_env_assets(NIF, dev)[0].model
    px = torch.arange(W * H, device=dev)
    fn = megastep.render_megastep_plain if plain else megastep.render_megastep
    return fn(load_scene(SCENE, dev), RenderSettings.make(samples_per_step=SPP, fov_degrees=FOV),
              model, (px % W).float(), (px // W).float(), (5, 23), width=W, height=H,
              max_path_length=L, **kw)


@pytest.mark.card
def test_k3_on_the_cornell_box_matches_plain(cuda):
    got = _launch(cuda)
    ref = _launch(cuda, plain=True)
    assert torch.equal(got.path_len, ref.path_len)
    assert int(ref.path_len.max()) > 3 * SPP  # deep paths ran
    a, b = got.radiance.stack(), ref.radiance.stack()
    assert bool(torch.isfinite(a).all())
    rel = (a - b).abs() / (b.abs() + 1e-2 * b.abs().max())
    print(f"median rel {float(rel.median()):.2e}, max {float(rel.max()):.2e}")
    assert float(rel.median()) < NIF_MEDIAN and float(rel.max()) < NIF_TAIL_MAX
    assert float((rel > NIF_MAX).any(dim=0).float().mean()) <= NIF_TAIL_FRACTION


@pytest.mark.card
def test_k3_trace_counters_on_the_cornell_box(cuda, monkeypatch):
    from ipu_path_trace_tpu_torch.utils import tracing
    from ipu_path_trace_tpu_torch.utils.tracing import TraceChannel

    kept = []
    keep = tracing.keep_launch
    monkeypatch.setattr(tracing, "keep_launch",
                        lambda stamps, tile_rays: (kept.append(stamps), keep(stamps, tile_rays)))
    untraced = _launch(cuda)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts), TraceChannel("t").loop():
        traced = _launch(cuda)
        torch.cuda.synchronize()
    for x, y in ((untraced.radiance.stack(), traced.radiance.stack()),
                 (untraced.path_len, traced.path_len)):
        assert torch.equal(x, y)
    (rec,) = tracing.launch_records()
    s = kept[0].cpu()
    blocks = -(-W * H // RAYS_PER_CUDA_BLOCK)
    assert rec.written == rec.blocks == blocks
    busy = s[:, 1] - s[:, 0]
    assert bool(((s[:, 6] > 0) & (s[:, 6] <= busy)).all())
    assert bool(((s[:, 8] > 0) & (s[:, 8] <= s[:, 7])).all())
    assert bool((s[:, 7] % 32 == 0).all() and (s[:, 7] <= 8 * 32 * L * SPP).all())
    plen = int(traced.path_len.sum())
    assert plen <= rec.trace_bounces <= plen + rec.lane_samples
    print(f"trace share {rec.trace_busy / rec.busy:.4f}, "
          f"lane useful {rec.trace_bounces / rec.trace_lane_iters:.4f}, "
          f"escape share {rec.escape_share:.4f}, chain useful {rec.chain_useful_share:.4f}, "
          f"mean bounces {rec.trace_bounces / rec.lane_samples:.3f}")
