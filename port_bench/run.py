#!/usr/bin/env python3
"""The benchmark of ipu_path_trace_tpu_torch: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run builds the renderer's
``PathTracerApp`` from the cell's configuration and traffic (as its
command line would), warms it up with one step (``execute(max_steps=1)``
without the checkpoint, which only the window's exit needs), then drives
its own device-film step loop (``execute``) for ``--seconds``: a timer started
with ``execute`` sets the flag that the command line's signal handler
sets (``stop_requested``), the loop finishes the step in flight and
takes its exit path (a final fetch, the exit checkpoint and save, outside
the window).  The window runs from the start of the first step to the
end of the last, which ends in a synchronise (the renderer's
``ipu_render`` spans); the paths are the film's sample counts over the
real pixels.  Set-up runs from the process's start to the first step;
the result's ``window.setup_timeline`` gives its phases (seconds from the
start, and the seconds of the app's ``create_path_tracing_jobs`` and
``resolve_env_skip`` spans).  Then the film is checked against the plain
reference (correct.py), and one JSON line is printed.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs
the window under ``torch.profiler`` and reports its per-layer metrics,
each read by ``metrics/<name>.py``.  Without CUDA, or with fewer cards
than the cell asks for, the run exits 2 and prints no result; it exits 3
if JAX or the JAX package was loaded.  Caches stay in the checkout:
the kernel library in ``build/kernels/``, profiler traces in
``build/port_bench/``; the exit save and checkpoint go to a directory of
``TMPDIR`` that the run removes.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BUILD = ROOT / "build"
# Every build and kernel cache at a fixed path inside the checkout.
CACHES = {"TRITON_CACHE_DIR": BUILD / "port_bench" / "triton",
          "TORCH_EXTENSIONS_DIR": BUILD / "port_bench" / "torch_extensions"}
TRACE_DIR = BUILD / "port_bench"
PROGRAM = "ipu_path_trace_tpu_torch"
# Top-level modules that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "ipu_path_trace_tpu")
STEP_SPAN = "ipu_render"
# The app's set-up spans whose seconds the set-up timeline reports.
SETUP_SPANS = ("create_path_tracing_jobs", "resolve_env_skip")
# Set-up phases before ``run_cell`` (seconds from T_START), filled by ``main``.
EARLY_PHASES: dict[str, float] = {}

EXIT_NO_CARD = 2
EXIT_FORBIDDEN = 3


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: the
    loaded ones), compared whole: ``ipu_path_trace_tpu_torch`` is not
    ``ipu_path_trace_tpu``."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


class Span(NamedTuple):
    name: str
    t0: float
    t1: float


def span_recorder(channel_cls):
    """A subclass of the renderer's ``TraceChannel`` that also keeps each
    span's host-clock start and end in memory."""

    class SpanRecorder(channel_cls):
        def __init__(self, name: str):
            super().__init__(name)
            self.events: list[Span] = []

        @contextlib.contextmanager
        def span(self, span_name: str):
            t0 = time.perf_counter()
            try:
                with super().span(span_name):
                    yield
            finally:
                self.events.append(Span(span_name, t0, time.perf_counter()))

    return SpanRecorder


@contextlib.contextmanager
def record_budgets(module):
    """Keep every call of the adaptive controller while the window runs, as
    ((r, g, b, lum2, sample_count, keywords), budgets): references only,
    no copy and no launch.  The step makes new tensors and changes none in
    place, so each call's inputs stay as the controller read them."""
    orig = module.compute_budgets
    calls = []

    def recorded(r, g, b, lum2, sample_count, **kw):
        out = orig(r, g, b, lum2, sample_count, **kw)
        calls.append(((r, g, b, lum2, sample_count, kw), out))
        return out

    module.compute_budgets = recorded
    try:
        yield calls
    finally:
        module.compute_budgets = orig


class Window(NamedTuple):
    t0: float  # the start of the first step
    t1: float  # the end of the last step
    steps: int
    trace_path: str | None


def run_window(app, seconds: float, trace_path: str | None) -> Window:
    """``app.execute()`` until the timer's stop flag, under the profiler
    when ``trace_path`` is given (exported there)."""
    import torch

    app.stop_requested = False
    timer = threading.Timer(seconds, lambda: setattr(app, "stop_requested", True))
    prof = contextlib.nullcontext()
    if trace_path:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    try:
        with prof as p:
            with torch.profiler.record_function("port_bench/window"):
                t0 = time.perf_counter()
                timer.start()
                app.execute()
    finally:
        timer.cancel()
        timer.join()
    if trace_path:
        p.export_chrome_trace(trace_path)
    steps = [s for s in app.trace.events if s.name == STEP_SPAN and s.t0 >= t0]
    if not steps:
        raise RuntimeError("the window took no step")
    return Window(steps[0].t0, steps[-1].t1, len(steps), trace_path)


def read_state(path: str) -> dict:
    """The device film from the renderer's exit checkpoint."""
    import numpy as np

    with np.load(path) as z:
        return {k[len("soa_"):]: z[k] for k in z.files if k.startswith("soa_")}


class LayerContext(NamedTuple):
    """What a per-layer reader (metrics/<name>.py) reads."""

    trace: object  # devtrace.DeviceTrace of the window
    config: dict
    traffic: dict
    steps: int
    paths: int  # camera paths of real pixels the window completed
    records: int  # worklist records the window's launches rendered (padding included)
    window_s: float  # host clock
    cards: int


def read_layers(cell, ctx: LayerContext) -> dict:
    out = {}
    for m in cell.per_layer:
        spec = importlib.util.spec_from_file_location(f"port_bench_metric_{m['name']}",
                                                      HERE / "metrics" / f"{m['name']}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return done.stdout.strip() or None


def run_cell(cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             control: bool = False) -> dict:
    """One run of ``cell``; returns the result line's object.  ``device``
    "cpu" runs the renderer's plain versions (the CPU tests, at a cut
    size); ``control`` adds the control's readings (``checks_control``)."""
    import numpy as np
    import torch

    from ipu_path_trace_tpu_torch.ops import _lib
    from ipu_path_trace_tpu_torch.render import adaptive as adaptive_mod
    from ipu_path_trace_tpu_torch.runtime.app import PathTracerApp
    from ipu_path_trace_tpu_torch.runtime.config import Config
    from ipu_path_trace_tpu_torch.utils.tracing import TraceChannel

    from port_bench import correct
    from port_bench.cells import app_config
    from port_bench.devtrace import DeviceTrace

    phases = dict(EARLY_PHASES)  # set-up's timeline, seconds from the start
    phases["imports"] = time.perf_counter() - T_START
    out_dir = tempfile.mkdtemp(prefix="port_bench_")
    try:
        cfg = Config(**app_config(cell, seed, out_dir, device))
        cfg.validate()
        cards = int(cfg.ipus) if device == "cuda" else 1
        if device == "cuda":
            _lib.configure(str(BUILD / "kernels"))
        app = PathTracerApp(cfg)
        app.trace = span_recorder(TraceChannel)(app.trace.name)
        app.init()  # the scene, the NIF asset, the mesh
        phases["init"] = time.perf_counter() - T_START
        app.build()  # the host runtime, the coherent worklist, the env-skip probe
        phases["build"] = time.perf_counter() - T_START
        for span in app.trace.events:
            if span.name in SETUP_SPANS:
                phases[f"{span.name}_s"] = span.t1 - span.t0
        # Warm-up: one step of the cell's shapes on every card.  Its exit
        # path still writes the images (execute() always does), but not
        # the checkpoint: only the window's exit needs one.
        checkpoint, cfg.checkpoint = cfg.checkpoint, ""
        app.execute(max_steps=1)
        cfg.checkpoint = checkpoint
        phases["warm_up"] = time.perf_counter() - T_START
        trace_path = None
        if trace:
            TRACE_DIR.mkdir(parents=True, exist_ok=True)
            trace_path = str(TRACE_DIR / f"trace_{cell.name}.json")
        budget_log = None
        with (record_budgets(adaptive_mod) if cfg.adaptive
              else contextlib.nullcontext()) as calls:
            win = run_window(app, seconds, trace_path)
        setup_s = win.t0 - T_START
        phases["first_step"] = setup_s
        logging.getLogger("port_bench").info("set-up timeline (s from the start): %s", ", ".join(
            f"{k} {v:.3f}" for k, v in phases.items()))
        if cfg.adaptive:
            budget_log = correct.BudgetLog(calls)
        peak = (max(torch.cuda.max_memory_allocated(d) for d in range(cards))
                if device == "cuda" else 0)
        state = read_state(cfg.checkpoint)
        records = len(state["u"])
        paths = int(state["sample_count"][state["u"] < cfg.width].astype(np.int64).sum())
        window_s = win.t1 - win.t0
        del app
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        result = {"correct": False, "attempted": win.steps, "failed": 0}
        dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                    "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                    "count": cards, "memory_peak_bytes": int(peak)}
        if trace:
            dtrace = DeviceTrace.load(trace_path)
            ctx = LayerContext(dtrace, cell.config, cell.traffic, win.steps, paths,
                               records * win.steps, window_s, cards)
            result["metrics"] = read_layers(cell, ctx)
            busy = [dtrace.busy_s(d) for d in range(cards)]
            dev_info.update(busy_s=sum(busy) / len(busy), window_s=dtrace.window_s)
            result["breakdown"] = {"device_ops": dtrace.top_ops(), "idle_gaps": dtrace.idle_gaps()}
        else:
            e2e = {"mpaths_per_s": paths / 1e6 / window_s, "setup_s": setup_s}
            result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                                 for m in cell.end_to_end}
        result["device"] = dev_info
        values, replayed = correct.check_run(cell, seed, state, win.steps, budget_log, device)
        ok, checks = correct.judge(values, cell.limits)
        result["correct"] = ok
        result["window"] = {"steps": win.steps, "paths": paths, "seconds": window_s,
                            "setup_timeline": phases,
                            "power": power_limit() if device == "cuda" else None}
        if control and replayed is not None:
            chosen, ref = replayed
            fp8 = correct.reference_sums(cell, seed, state, win.steps, budget_log, chosen, device,
                                         precision="fp8")
            result["checks_control"] = {"rgb_rel_l1": correct.rel_l1(
                np.stack([fp8.r, fp8.g, fp8.b]), np.stack([ref.r, ref.g, ref.b]))}
            if budget_log is not None:
                result["checks_control"]["lum2_rel_l1"] = correct.rel_l1(fp8.lum2, ref.lum2)
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="A cell's name in BENCHMARK.json.")
    p.add_argument("--seed", type=int, required=True, help="Seed of the run's inputs.")
    p.add_argument("--seconds", type=float, required=True, help="Length of the window.")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: the per-layer metrics from a profiled window.")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    try:
        from port_bench.cells import load_cell

        cell = load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"error: cannot load the cell: {e}", file=sys.stderr)
        return 1
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"error: the renderer ({PROGRAM}) is not in this checkout", file=sys.stderr)
        return 1
    import torch

    EARLY_PHASES["torch"] = time.perf_counter() - T_START
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: the cell needs {cell.chips} CUDA device(s); {have} available",
              file=sys.stderr)
        return EXIT_NO_CARD
    EARLY_PHASES["cuda_found"] = time.perf_counter() - T_START
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return EXIT_FORBIDDEN
    emit(result)
    return 0


def emit(result: dict) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
