"""A run with the timed path broken underneath must come out not correct.

Each fault is planted in the renderer (its plain versions on the CPU, at a
tiny size) and the rest of the run is the harness's own, from the app's
set-up to the check: a step that returns its state unchanged; half of a
step's samples left out and the rest doubled; the gather of the mesh's
shards left out; an answer altered where it is produced (the radiance's
red and blue swapped); the adaptive controller's budgets replaced by
uniform ones, at every step or at the second step alone.  The same runs
without a fault are correct."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

import ipu_path_trace_tpu_torch.ops.megastep as megastep  # noqa: E402
import ipu_path_trace_tpu_torch.render.adaptive as adaptive  # noqa: E402
import ipu_path_trace_tpu_torch.runtime.app as app  # noqa: E402
from ipu_path_trace_tpu_torch.core.records import WorkBatch  # noqa: E402
from ipu_path_trace_tpu_torch.core.vecmath import Vec3  # noqa: E402

from port_bench import run  # noqa: E402
from port_bench.cells import load_cell  # noqa: E402

SIZES = {"alley320.batch300": (24, 16, 2), "alley320.adaptive128": (64, 80, 4),
         "alley320.ipus4": (24, 16, 2)}


def cut(name):
    c = load_cell(name)
    w, h, spp = SIZES[name]
    return c._replace(config={**c.config, "width": w, "height": h},
                      traffic={**c.traffic, "samples_per_step": spp, "adaptive_min": 1})


def _unchanged(mp):
    mp.setattr(app, "render_step", lambda scene, settings, cfg, work, *a, **k: work)
    mp.setattr(app, "adaptive_render_step", lambda s, st, cfg, work, lum2, *a, **k: (work, lum2))
    mp.setattr(app, "sharded_render_step", lambda s, st, cfg, work, *a, **k: work)


def _half_batch(mp):
    orig = megastep.render_megastep

    def half(scene, settings, model, cols, rows, seed=None, *, budgets=None, **kw):
        settings = settings._replace(samples_per_step=max(1, settings.samples_per_step // 2))
        if budgets is not None:
            budgets = torch.clamp_min(budgets // 2, 1)
        out = orig(scene, settings, model, cols, rows, seed, budgets=budgets, **kw)
        return out._replace(radiance=out.radiance * 2.0, path_len=out.path_len * 2,
                            lum2=None if out.lum2 is None else out.lum2 * 2.0)

    mp.setattr(megastep, "render_megastep", half)


def _exchange_left_out(mp):
    def gather(sharded, device=None):
        first = [row[0] for row in sharded.parts]
        first = [first[0]] * len(first)  # only shard 0's records come back
        return WorkBatch(*(torch.cat([getattr(p, f).to(device) for p in first])
                           for f in WorkBatch._fields))

    mp.setattr(app, "gather_work", gather)


def _answer_altered(mp):
    orig = megastep.render_megastep

    def swapped(*a, **kw):
        out = orig(*a, **kw)
        r = out.radiance
        return out._replace(radiance=Vec3(r.z, r.y, r.x))

    mp.setattr(megastep, "render_megastep", swapped)


def _uniform_budgets(mp):
    def uniform(r, g, b, lum2, sample_count, *, block_size, samples_per_step, **kw):
        return torch.full((-(-r.shape[0] // block_size),), samples_per_step, dtype=torch.int32)

    mp.setattr(adaptive, "compute_budgets", uniform)


def _second_budgets_uniform(mp):
    """The controller wrong at the window's second step alone (the warm-up's
    step makes the first call), between the window's first and last."""
    orig = adaptive.compute_budgets
    calls = []

    def once_uniform(r, g, b, lum2, sample_count, *, block_size, samples_per_step, **kw):
        calls.append(None)
        out = orig(r, g, b, lum2, sample_count, block_size=block_size,
                   samples_per_step=samples_per_step, **kw)
        return torch.full_like(out, samples_per_step) if len(calls) == 3 else out

    mp.setattr(adaptive, "compute_budgets", once_uniform)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "answer_altered": _answer_altered,
          "exchange_left_out": _exchange_left_out, "uniform_budgets": _uniform_budgets,
          "second_budgets_uniform": _second_budgets_uniform}
BUDGET_FAULTS = ("uniform_budgets", "second_budgets_uniform")
CASES = [(c, f) for c in SIZES for f in FAULTS
         if (f != "exchange_left_out" or "ipus" in c)
         and (f not in BUDGET_FAULTS or "adaptive" in c)]


@pytest.mark.parametrize("cell", list(SIZES))
def test_sound_run_is_correct(cell):
    result = run.run_cell(cut(cell), 2**31 + 41, 1.5, False, device="cpu")
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    # A budget fault shows only past the window's first step, a cold start
    # whose budgets are uniform anyway; the one at the second step needs a
    # window of a few steps to fall between the first and the last.
    seconds = 4.0 if fault in BUDGET_FAULTS else 1.5
    result = run.run_cell(cut(cell), 2**31 + 41, seconds, False, device="cpu")
    assert not result["correct"], result["checks"]
    if fault == "second_budgets_uniform":  # caught by the budgets, not by the film
        assert result["checks"]["budget_mismatch"]["value"] > 0, result["checks"]
