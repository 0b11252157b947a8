"""K3's escape queue on the card (csrc/megastep.cuh): each block queues the
escapes of its samples and runs the NIF chain on full tiles of them (128
rays; 64 on the tf32 chain), the last tile after its last sample.

    python -m pytest --noconftest tests/test_torch_megastep_queue.py -m card -s

At 128x96 with 8 Philox samples, on the smallpt Cornell box (about 30% of
paths escape) and the default scene (about 94%), with the bf16, int8 and
tf32 chains, uniform and with budgets (one group at 0) and the
statistics: the kernel against its plain version, path lengths bit for
bit, radiance and sqrt(lum2) within chip_smoke.py's limits for the chain
(bf16: the NIF budget; int8: every sample bit for bit, so the sums within
their reordering's rounding; tf32: the reference's f32 budget); traced and
untraced launches, and two untraced launches, bit-identical; and each
block's record showing ceil(escapes / tile rays) tiles shaded.
"""

import pytest
import torch

from ipu_path_trace_tpu_torch.ops import megastep

SCENES = {"cornell": ("assets/scenes/cornell_smallpt.json", 37.79556976963653),
          "default": (None, None)}  # fov: port_bench/configs/cornell_smallpt.json
NIF = "assets/urban_alley_synth_nif"
NIF_INT8 = "assets/urban_alley_synth_nif_int8"
W, H, SPP, L = 128, 96, 8, 10
# chip_smoke.py's limits against the plain version: mode_check's for the
# bf16 chain, SUM_ORDER_REL's rule for int8 (4S 2^-24 for S samples),
# probes/tf32_chain's F32_MAX for tf32.
NIF_MEDIAN, NIF_MAX = 5e-3, 8e-2
NIF_TAIL_FRACTION, NIF_TAIL_MAX = 1e-4, 0.25
F32_MAX = 1.5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda")


def _model(chain, dev):
    from ipu_path_trace_tpu_torch.models.nif import load_nif_assets
    from ipu_path_trace_tpu_torch.runtime.app import parse_env_assets

    if chain == "tf32":
        return load_nif_assets(NIF, torch.float32, dev)[0]
    return parse_env_assets(NIF_INT8 if chain == "int8" else NIF, dev,
                            "int8" if chain == "int8" else "auto")[0].model


def _scene(name, dev):
    from ipu_path_trace_tpu_torch.core.scene import default_scene
    from ipu_path_trace_tpu_torch.core.scenefile import load_scene
    from ipu_path_trace_tpu_torch.render.params import RenderSettings

    path, fov = SCENES[name]
    fov_kw = {} if fov is None else {"fov_degrees": fov}
    return (default_scene(dev) if path is None else load_scene(path, dev),
            RenderSettings.make(samples_per_step=SPP, **fov_kw))


def _stacks(out):
    return [out.radiance.stack(), out.path_len] + ([] if out.lum2 is None else [out.lum2])


def _close(chain, a, b, samples):
    """a (the kernel) against b (the plain version) by the chain's rule."""
    assert bool(torch.isfinite(a).all())
    if chain == "int8":
        return bool(((a - b).abs() <= samples * 2.0 ** -22 * b.abs()).all())
    rel = (a - b).abs() / (b.abs() + 1e-2 * b.abs().max())
    print(f"{chain}: median rel {float(rel.median()):.2e}, max {float(rel.max()):.2e}")
    if chain == "tf32":
        return float(rel.max()) < F32_MAX
    return (float(rel.median()) < NIF_MEDIAN and float(rel.max()) < NIF_TAIL_MAX
            and float((rel > NIF_MAX).any(dim=0).float().mean()) <= NIF_TAIL_FRACTION)


@pytest.mark.card
@pytest.mark.parametrize("budgeted", [False, True])
@pytest.mark.parametrize("chain", ["bf16", "int8", "tf32"])
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_queue_matches_plain(cuda, monkeypatch, scene_name, chain, budgeted):
    from ipu_path_trace_tpu_torch.utils import tracing
    from ipu_path_trace_tpu_torch.utils.tracing import TraceChannel

    scene, settings = _scene(scene_name, cuda)
    model = _model(chain, cuda)
    px = torch.arange(W * H, device=cuda)
    cols, rows = (px % W).float(), (px // W).float()
    kw = dict(width=W, height=H, max_path_length=L)
    samples = SPP
    if budgeted:  # six 2048-ray groups, one at 0 and one at twice the step
        budgets = torch.tensor([3, 0, 16, 8, 1, 5], dtype=torch.int32, device=cuda)
        kw.update(budgets=budgets, with_stats=True)
        samples = int(budgets.max())

    def launch(plain=False, **extra):
        fn = megastep.render_megastep_plain if plain else megastep.render_megastep
        return fn(scene, settings, model, cols, rows, (5, 23), **kw, **extra)

    kept = []
    keep = tracing.keep_launch
    monkeypatch.setattr(tracing, "keep_launch",
                        lambda stamps, tile_rays: (kept.append(stamps), keep(stamps, tile_rays)))
    got = launch()
    again = launch()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts), TraceChannel("t").loop():
        traced = launch()
        torch.cuda.synchronize()
    ref = launch(plain=True)
    for other in (again, traced):
        assert all(torch.equal(x, y) for x, y in zip(_stacks(got), _stacks(other)))
    assert torch.equal(got.path_len, ref.path_len)
    assert _close(chain, got.radiance.stack(), ref.radiance.stack(), samples)
    if budgeted:
        assert _close(chain, got.lum2.sqrt()[None], ref.lum2.sqrt()[None], samples)
    (rec,) = tracing.launch_records()
    s = kept[0].cpu()
    tile = megastep.chain_tile(model)
    assert rec.written == rec.blocks == -(-W * H // megastep.RAYS_PER_CUDA_BLOCK)
    assert torch.equal(s[:, 5], -(-s[:, 4] // tile))  # tiles = ceil(escapes / tile rays)
    assert int(s[:, 4].sum()) > 0
    print(f"{scene_name} {chain}: escape share {rec.escape_share:.4f}, "
          f"chain useful {rec.chain_useful_share:.4f}, tiles {rec.tile_passes}")
