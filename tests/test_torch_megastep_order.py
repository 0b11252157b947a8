"""K3's dispatch of an adaptive launch: its 256-ray blocks heaviest budget
first (ops/megastep.block_order, csrc/megastep.cuh's ticket).

On the CPU, the order itself: a permutation of every block, budgets that
do not increase along it, ties in block index order, the identity for
uniform budgets, the ragged last block counted once, at budget blocks of
256 and 2048 rays.

On the card (marked ``card``; it skips without CUDA):

    python -m pytest --noconftest tests/test_torch_megastep_order.py -m card -s

with a budget vector whose highest-index group holds the cap and every
other group the floor: the kernel matches its plain version for the bf16
and int8 chains in the Philox and host-noise modes, two launches and a
launch in index order are bit-identical, ``ordered_launches`` counts the
launches with budgets alone, an ordered launch syncs nowhere, and with
tracing on the heavy group's blocks are among the first to start and the
last-started block runs under a tenth of the launch; in index order the
same launch's tail is over a tenth.  ptxas reports no spills for K3's
production kernels (their registers and stacks are printed).
"""

import functools
import re

import pytest
import torch

from ipu_path_trace_tpu_torch.ops import megastep
from ipu_path_trace_tpu_torch.ops.megastep import RAYS_PER_CUDA_BLOCK, block_order

NIF = "assets/urban_alley_synth_nif"
NIF_INT8 = "assets/urban_alley_synth_nif_int8"
FLOOR, CAP = 1, 8  # the adversarial budgets of the checks against the plain version


def _blocks(n):
    return -(-n // RAYS_PER_CUDA_BLOCK)


def _reference_order(budgets, n, budget_block):
    """The order by definition: block k's budget is its group's, sorted by
    (-budget, k)."""
    bud = [int(budgets[k * RAYS_PER_CUDA_BLOCK // budget_block]) for k in range(_blocks(n))]
    return sorted(range(len(bud)), key=lambda k: (-bud[k], k)), bud


def _adversarial(n, budget_block, floor, cap, device=None):
    """The floor everywhere but the highest-index group, which holds the cap."""
    budgets = torch.full((-(-n // budget_block),), floor, dtype=torch.int32, device=device)
    budgets[-1] = cap
    return budgets


@pytest.mark.parametrize("budget_block", [256, 2048])
@pytest.mark.parametrize("n", [1, 255, 256, 2048, 5 * 2048 + 1, 1104 * 1000 // 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_order_is_a_sorted_stable_permutation(budget_block, n, seed):
    """Every block once; budgets non-increasing along the order; equal
    budgets in block index order: the stable sort by definition."""
    gen = torch.Generator().manual_seed(seed)
    budgets = torch.randint(0, 6, (-(-n // budget_block),), generator=gen, dtype=torch.int32)
    order = block_order(budgets, n, budget_block)
    want, bud = _reference_order(budgets, n, budget_block)
    assert order.dtype == torch.int32 and order.shape == (_blocks(n),)
    assert sorted(order.tolist()) == list(range(_blocks(n)))
    along = [bud[k] for k in order.tolist()]
    assert all(a >= b for a, b in zip(along, along[1:]))
    assert order.tolist() == want


@pytest.mark.parametrize("budget_block", [256, 2048])
@pytest.mark.parametrize("budget", [0, 8, 128])
def test_uniform_budgets_give_the_identity(budget_block, budget):
    """The cold-start step's uniform budgets dispatch in index order."""
    n = 1104 * 1000 // 8
    budgets = torch.full((-(-n // budget_block),), budget, dtype=torch.int32)
    assert torch.equal(block_order(budgets, n, budget_block),
                       torch.arange(_blocks(n), dtype=torch.int32))


@pytest.mark.parametrize("budget_block", [256, 2048])
def test_ragged_last_group_is_one_block(budget_block):
    """A last group of fewer than 256 rays is one block, with its group's
    budget: at the cap it comes first, at the floor last."""
    n = 7 * budget_block + 128
    blocks = _blocks(n)
    assert blocks == 7 * budget_block // RAYS_PER_CUDA_BLOCK + 1
    heavy = block_order(_adversarial(n, budget_block, 8, 2048), n, budget_block).tolist()
    assert heavy.count(blocks - 1) == 1 and heavy[0] == blocks - 1
    assert heavy[1:] == list(range(blocks - 1))
    light = block_order(_adversarial(n, budget_block, 2048, 8), n, budget_block).tolist()
    assert light == list(range(blocks))


@pytest.mark.parametrize("budget_block", [256, 2048])
def test_heaviest_group_leads(budget_block):
    """The highest-index group at the cap, the rest at the floor: its
    blocks lead in index order, then every other block in index order."""
    n = 64 * budget_block
    per = budget_block // RAYS_PER_CUDA_BLOCK
    blocks = _blocks(n)
    order = block_order(_adversarial(n, budget_block, 8, 2048), n, budget_block).tolist()
    assert order == list(range(blocks - per, blocks)) + list(range(blocks - per))


def test_cpu_launch_is_the_plain_version():
    """A CPU launch with budgets runs the plain version: no kernel, so no
    ordered launch is counted."""
    from ipu_path_trace_tpu_torch.core.scene import default_scene
    from ipu_path_trace_tpu_torch.models.nif import make_params, make_synthetic_nif
    from ipu_path_trace_tpu_torch.render.params import RenderSettings

    torch.set_num_threads(1)
    model = make_params(*make_synthetic_nif(key=5, hidden=32, num_hidden=2, skip_layer=1))
    n = 300
    before = (megastep.render_megastep.launches, megastep.render_megastep.ordered_launches)
    cols = torch.arange(n, dtype=torch.float32) % 20
    rows = torch.arange(n, dtype=torch.float32) // 20
    out = megastep.render_megastep(
        default_scene(), RenderSettings.make(samples_per_step=2), model, cols, rows, (3, 4),
        width=20, height=15, max_path_length=2, budgets=_adversarial(n, 256, 0, 2),
        budget_block=256)
    assert out.path_len.shape == (n,) and not out.path_len[:256].any()
    assert (megastep.render_megastep.launches,
            megastep.render_megastep.ordered_launches) == before


# --- on the card -----------------------------------------------------------

# chip_smoke.py::mode_check's limits for the bf16 chain against its plain
# version; the int8 chain matches each sample's terms bit for bit, and K3's
# escape queue adds them in another order, so its sums agree to
# chip_smoke.py's SUM_ORDER_REL (4S 2^-24 for S samples).
SUM_ORDER_REL = CAP * 2.0 ** -22
NIF_MEDIAN, NIF_MAX = 5e-3, 8e-2
NIF_TAIL_FRACTION, NIF_TAIL_MAX = 1e-4, 0.25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda")


def _frame(w, h, dev):
    px = torch.arange(w * h, device=dev)
    return (px % w).float(), (px // w).float()


def _model(asset, dev):
    from ipu_path_trace_tpu_torch.runtime.app import parse_env_assets

    return parse_env_assets(asset, dev, "int8" if asset == NIF_INT8 else "auto")[0].model


@functools.cache
def _scene(dev):
    """The default scene, built once (its build copies to the card)."""
    from ipu_path_trace_tpu_torch.core.scene import default_scene

    return default_scene(dev)


def _launch(model, cols, rows, w, h, plain=False, **kw):
    from ipu_path_trace_tpu_torch.render.params import RenderSettings

    fn = megastep.render_megastep_plain if plain else megastep.render_megastep
    return fn(_scene(cols.device), RenderSettings.make(samples_per_step=CAP), model, cols, rows,
              width=w, height=h, max_path_length=10, **kw)


def _stacks(out):
    return [out.radiance.stack(), out.path_len] + ([] if out.lum2 is None else [out.lum2])


def _identical(a, b):
    return all(torch.equal(x, y) for x, y in zip(_stacks(a), _stacks(b)))


def _index_order(monkeypatch):
    """Make block_order return the identity: the launch dispatches in index
    order (the mapping of a launch without budgets)."""
    monkeypatch.setattr(megastep, "block_order", lambda budgets, n, budget_block: torch.arange(
        _blocks(n), dtype=torch.int32, device=budgets.device))


@pytest.mark.card
@pytest.mark.parametrize("asset", [NIF, NIF_INT8])
@pytest.mark.parametrize("mode", ["philox", "host"])
def test_ordered_launch_matches_plain(cuda, monkeypatch, asset, mode):
    """The adversarial budgets (the last 2048-ray group at 8 samples, the
    others at 1) at 256x256 with the statistics: the kernel against its
    plain version (path lengths bit for bit; radiance and sqrt(lum2)
    within SUM_ORDER_REL with int8, within chip_smoke's bf16 limits with
    bf16); two launches, and a launch in index order, bit-identical."""
    w, h = 256, 256
    model = _model(asset, cuda)
    cols, rows = _frame(w, h, cuda)
    budgets = _adversarial(w * h, megastep.BUDGET_BLOCK, FLOOR, CAP, cuda)
    kw = dict(budgets=budgets, with_stats=True)
    if mode == "host":
        gen = torch.Generator(cuda).manual_seed(11)
        noise = torch.rand((CAP, 44, w * h), generator=gen, device=cuda)
        noise[:, 0:2] = torch.randn((CAP, 2, w * h), generator=gen, device=cuda)
        kw["noise"] = noise
    else:
        kw["seed"] = (7, 9)
    got = _launch(model, cols, rows, w, h, **kw)
    again = _launch(model, cols, rows, w, h, **kw)
    with monkeypatch.context() as m:
        _index_order(m)
        in_index_order = _launch(model, cols, rows, w, h, **kw)
    ref = _launch(model, cols, rows, w, h, plain=True, **kw)
    assert _identical(got, again) and _identical(got, in_index_order)
    assert torch.equal(got.path_len, ref.path_len)
    pairs = [(got.radiance.stack(), ref.radiance.stack()), (got.lum2.sqrt()[None],
                                                            ref.lum2.sqrt()[None])]
    if asset == NIF_INT8:
        assert all(bool(((a - b).abs() <= SUM_ORDER_REL * b.abs()).all()) for a, b in pairs)
        return
    for a, b in pairs:
        assert bool(torch.isfinite(a).all())
        rel = (a - b).abs() / (b.abs() + 1e-2 * b.abs().max())
        print(f"{mode}: median rel {float(rel.median()):.2e}, max {float(rel.max()):.2e}")
        assert float(rel.median()) < NIF_MEDIAN and float(rel.max()) < NIF_TAIL_MAX
        assert float((rel > NIF_MAX).any(dim=0).float().mean()) <= NIF_TAIL_FRACTION


@pytest.mark.card
def test_ordered_launches_count_and_sync_nowhere(cuda):
    """Only launches with budgets take the order (and count); a warm
    ordered launch syncs nowhere."""
    w, h = 128, 64
    model = _model(NIF, cuda)
    cols, rows = _frame(w, h, cuda)
    budgets = _adversarial(w * h, megastep.BUDGET_BLOCK, FLOOR, CAP, cuda)
    _launch(model, cols, rows, w, h, seed=(1, 2), budgets=budgets)  # build and warm
    fn = megastep.render_megastep
    launches, ordered = fn.launches, fn.ordered_launches
    _launch(model, cols, rows, w, h, seed=(1, 2))
    _launch(model, cols, rows, w, h, seed=(1, 2), with_stats=True)
    assert (fn.launches - launches, fn.ordered_launches - ordered) == (2, 0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _launch(model, cols, rows, w, h, seed=(1, 2), budgets=budgets, with_stats=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (fn.launches - launches, fn.ordered_launches - ordered) == (3, 1)


@pytest.mark.card
def test_heavy_blocks_start_first(cuda, monkeypatch):
    """1024x1024 in 2048-ray groups, the last group at 128 samples and the
    others at 8, traced: the heavy group's 8 blocks are among the first
    `slots` blocks to start and the last-started block runs under a tenth
    of the launch's span.  In index order (the control) the heavy blocks
    start last and the tail is over a tenth."""
    from ipu_path_trace_tpu_torch.utils import tracing
    from ipu_path_trace_tpu_torch.utils.tracing import TraceChannel

    w = h = 1024
    model = _model(NIF, cuda)
    cols, rows = _frame(w, h, cuda)
    budgets = _adversarial(w * h, megastep.BUDGET_BLOCK, 8, 128, cuda)
    blocks, per = _blocks(w * h), megastep.BUDGET_BLOCK // RAYS_PER_CUDA_BLOCK
    heavy = set(range(blocks - per, blocks))
    kept = []

    class Keep(TraceChannel):
        def keep_launch(self, stamps, tile_rays):
            kept.append(stamps)
            super().keep_launch(stamps, tile_rays)

    def traced():
        kept.clear()
        _launch(model, cols, rows, w, h, seed=(3, 5), budgets=budgets)  # warm
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts), Keep("t").loop():
            _launch(model, cols, rows, w, h, seed=(3, 5), budgets=budgets)
            torch.cuda.synchronize()
        (rec,) = tracing.launch_records()
        starts = kept[0][:, 0].cpu()
        first = set(torch.argsort(starts, stable=True)[:rec.slots].tolist())
        print(f"blocks {rec.blocks} slots {rec.slots} fill {rec.fill:.4f} tail "
              f"{rec.tail * 1e3:.3f} ms span {rec.span * 1e3:.3f} ms heavy in first wave "
              f"{len(heavy & first)}/{len(heavy)}")
        assert rec.written == rec.blocks == blocks
        return rec, first

    rec, first = traced()
    assert heavy <= first and rec.tail < 0.1 * rec.span
    with monkeypatch.context() as m:
        _index_order(m)
        ctl, ctl_first = traced()
    assert not heavy & ctl_first and ctl.tail > 0.1 * ctl.span and ctl.fill < rec.fill


@pytest.mark.card
def test_k3_ptxas_no_spills(cuda):
    """ptxas's figures for K3's production kernels (every RNG mode and
    chain, untraced and recording): no spills, and the bf16 Philox pair
    at 168 registers and a 32-byte stack.  Printed."""
    from ipu_path_trace_tpu_torch.ops import _lib

    _lib.library()
    log = _lib.library_path().with_suffix(".log").read_text().splitlines()
    entry = re.compile(r"Compiling entry function "
                       r"'_ZN2pt18megastep_wg_kernelILi(\d)ELi0ELi(\d)ELb([01])EE")
    seen = 0
    for i, ln in enumerate(log):
        m = entry.search(ln)
        if not m:
            continue
        lines = [x.strip() for x in log[i + 1:i + 4]
                 if "registers" in x or "spill" in x or "stack" in x]
        print(f"ptxas megastep_wg_kernel<{m[1]},0,{m[2]},{m[3]}>:", " | ".join(lines))
        assert lines and all(int(b) == 0 for x in lines
                             for b in re.findall(r"(\d+) bytes spill", x))
        if (m[1], m[2]) == ("0", "2"):  # bf16 Philox: the parent's figures
            text = " ".join(lines)
            assert "Used 168 registers" in text and "32 bytes stack frame" in text
        seen += 1
    assert seen == 18  # 3 RNG modes x 3 chains x (untraced, recording)
