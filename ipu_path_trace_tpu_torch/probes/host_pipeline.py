"""Host-pipeline timing of the CLI, for one or more checkouts of the port.

    python3 -m ipu_path_trace_tpu_torch.probes.host_pipeline --trees build/parent .

For each configuration - the smoke check's main run (1104x1000, 16 spp in
two steps of 8) and the reference's canonical step (1200 spp in four
steps of 300, ``--save-interval 1``) - runs each tree's CLI (``python3 -m
ipu_path_trace_tpu_torch.runtime.cli`` with the tree as the working
directory, so each runs its own code) in turns, first to last and back
(with two trees: a, b, b, a), then once more per tree under
``--profile-dir``.  From each run's log it reads the render loop's
seconds ("Render finished"), each step's and each save's seconds, the
seconds each step waited for the host task (trees with one) and, from
the profiled run's ``trace.json``, the card's busy share of the render
window (``profile_report``).  Prints one line per run, the card's name
and power limit, and a JSON summary as the last line; ``--out`` also
writes the summary there.  Needs CUDA: it times the card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

CONFIGS = {
    "main 16 spp": ["-w", "1104", "-H", "1000", "-s", "16", "--samples-per-step", "8"],
    "canonical 1200 spp": ["-w", "1104", "-H", "1000", "-s", "1200", "--samples-per-step", "300",
                           "--save-interval", "1"],
}
ASSET = "assets/urban_alley_synth_nif"
_SECONDS = re.compile(r" in ([0-9.]+) seconds")
_WAIT = re.compile(r"wait for host ([0-9.]+)")
_FINISHED = re.compile(r"Render finished: ([0-9.]+) seconds")


def profile_report(trace_json: Path) -> dict:
    """Device kernel events of a torch.profiler Chrome trace by name, and
    the device's busy share of the render window: from the first
    tpu_path_tracer/ipu_render span to the end of the last app span."""
    events = json.loads(trace_json.read_text())["traceEvents"]
    spans = [e for e in events if str(e.get("name", "")).startswith("tpu_path_tracer/")
             and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        acc = by_name.setdefault(e["name"], [0, 0.0])
        acc[0] += 1
        acc[1] += float(e["dur"])
    renders = [e for e in spans if e["name"] == "tpu_path_tracer/ipu_render"]
    if not renders or not kernels:
        return {"span_names": sorted({e["name"] for e in spans}), "kernel_events": 0,
                "kernels_by_name": {}, "busy_share": None}
    lo = min(float(e["ts"]) for e in renders)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    busy, end = 0.0, lo
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return {"span_names": sorted({e["name"] for e in spans}), "kernel_events": len(kernels),
            "kernels_by_name": {k: {"count": c, "us": round(t, 1)} for k, (c, t) in
                                sorted(by_name.items(), key=lambda kv: -kv[1][1])},
            "window_ms": (hi - lo) / 1e3, "busy_share": busy / (hi - lo)}


def read_log(text: str) -> dict:
    """The loop's, steps', saves' and waits' seconds of one CLI log."""
    lines = text.splitlines()
    steps = [ln for ln in lines if "Completed render step" in ln]
    finished = [float(m.group(1)) for ln in lines if (m := _FINISHED.search(ln))]
    return {
        "render_s": finished[-1] if finished else None,
        "step_s": [float(_SECONDS.search(ln).group(1)) for ln in steps],
        "save_s": [float(_SECONDS.search(ln).group(1)) for ln in lines
                   if "Saved images" in ln and _SECONDS.search(ln)],
        "wait_s": [float(m.group(1)) for ln in steps if (m := _WAIT.search(ln))] or None,
    }


def run_cli(tree: Path, flags: list[str], out: Path, profile: bool) -> dict:
    out = out.resolve()  # the CLI runs in the tree
    out.mkdir(parents=True, exist_ok=True)
    argv = [sys.executable, "-m", "ipu_path_trace_tpu_torch.runtime.cli", *flags,
            "--assets", str(tree.resolve() / ASSET), "-o", str(out / "frame.png")]
    if profile:
        shutil.rmtree(out / "profile", ignore_errors=True)
        argv += ["--profile-dir", str(out / "profile")]
    t0 = time.monotonic()
    res = subprocess.run(argv, cwd=tree, capture_output=True, text=True, timeout=900)
    secs = time.monotonic() - t0
    if res.returncode:
        raise SystemExit(f"host_pipeline: {tree} exited {res.returncode}:\n"
                         f"{(res.stdout + res.stderr)[-4000:]}")
    got = {"process_s": secs, **read_log(res.stdout + res.stderr)}
    if profile:
        prof = profile_report(out / "profile" / "trace.json")
        got.update(busy_share=prof["busy_share"], window_ms=prof.get("window_ms"),
                   span_names=prof["span_names"])
    return got


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi failed"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="checkouts of the port to time (each runs its own code)")
    ap.add_argument("--work-dir", default="build/host_pipeline",
                    help="where the frames and profiles go")
    ap.add_argument("--out", default="", help="also write the JSON summary here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_pipeline: CUDA is not available; this probe times the card")
    smi = nvidia_smi()
    print(smi, flush=True)
    trees = [Path(t) for t in args.trees]
    order = trees + trees[::-1]  # in turns: a, b, b, a
    summary = {"nvidia_smi": smi, "runs": []}
    for name, flags in CONFIGS.items():
        for i, tree in enumerate(order + trees):
            profile = i >= len(order)
            got = run_cli(tree, flags, Path(args.work_dir) / f"{i}", profile)
            row = {"config": name, "tree": str(tree), "profiled": profile, **got}
            summary["runs"].append(row)
            print(f"[host_pipeline] {name} {tree}{' profiled' if profile else ''}: "
                  f"render {got['render_s']} s, steps {got['step_s']} s, saves {got['save_s']} s, "
                  f"waits {got['wait_s']} s, process {got['process_s']:.2f} s"
                  + (f", busy share {got['busy_share']}, window {got['window_ms']} ms"
                     if profile else "") + f" ({smi})", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(smi)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
