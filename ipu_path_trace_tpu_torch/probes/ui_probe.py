"""The remote UI against a live render on the card, measured.

Counterpart of ``scripts/ui_tpu_probe.py``: the port's CLI
(``runtime/cli.py``) in a subprocess holds the card with ``--ui-port``,
and the port's client (``ui/client.py``) drives it over TCP through the
probe's phases:

  1. ``preview``: the first preview's latency (the kernels' build
     included), then the preview rate and bytes over ``--window`` (20) s;
  2. ``exposure_no_restart``: a tone-map change; previews keep coming and
     the progress does not reset;
  3. ``env_rotation_restart``: a restart change; the progress drops;
  4. ``load_nif_hot_swap``: ``load_nif`` of ``assets/nif_w256e16``; the
     progress drops and previews resume on the new NIF;
  5. ``remote_stop``: ``stop_render``; the CLI exits 0 and saves the image.

Then the seconds of every render step the CLI logged ("Completed render
step i/n in X seconds"), their median, and the share of slow steps (more
than twice the median: PERF.md's open question on the UI's slow steps).

    python3 -m ipu_path_trace_tpu_torch.probes.ui_probe --out DIR [--size 512 [--height H]] \\
        [--port 5179] [--window 20] [--device-film] [--denoise] [--device cuda|cpu]

writes ``DIR/ui_probe.json``, the CLI's log ``DIR/cli.log`` and its image
``DIR/probe.png``; exits 1 when a phase fails.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time

from . import _study

# Seconds to wait for: the first preview (the kernels' build included), a
# restart, the NIF swap's resumed previews, the CLI's exit after a stop.
FIRST_TIMEOUT, RESTART_TIMEOUT, SWAP_TIMEOUT, STOP_TIMEOUT = 600.0, 60.0, 300.0, 180.0
STEP_RE = re.compile(r"Completed render step (\d+)/\d+ in ([0-9.]+) seconds")


def step_seconds(log_text: str) -> list[float]:
    """The seconds of each 'Completed render step' line of the CLI's log."""
    return [float(m.group(2)) for m in STEP_RE.finditer(log_text)]


def slow_share(secs: list[float]) -> dict:
    """Median step seconds and the share of steps above twice the median."""
    if not secs:
        return {"steps": 0, "median_s": None, "slow_share": None}
    med = statistics.median(secs)
    return {"steps": len(secs), "median_s": med, "min_s": min(secs), "max_s": max(secs),
            "slow_threshold_s": 2 * med, "slow_share": sum(s > 2 * med for s in secs) / len(secs)}


def wait(pred, timeout: float, proc) -> bool:
    """Poll ``pred`` every 0.2 s until it holds, the CLI exits or time runs out."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        if proc.poll() is not None:
            return False
        time.sleep(0.2)
    return pred()


def drive(client, proc, args, out) -> list[dict]:
    """The five phases; each a dict with its 'phase' and 'ok'."""
    phases = []
    t0 = time.monotonic()
    first = wait(lambda: client.preview_count > 0, FIRST_TIMEOUT, proc)
    first_s = time.monotonic() - t0
    n0, b0 = client.preview_count, client.preview_bytes
    time.sleep(args.window)
    frames = client.preview_count - n0
    phases.append({"phase": "preview", "ok": first and frames > 0,
                   "first_frame_s": round(first_s, 2), "fps": round(frames / args.window, 3),
                   "MB_per_s": round((client.preview_bytes - b0) / 1e6 / args.window, 4),
                   "progress": round(client.progress, 5),
                   "Mpaths_per_s": round(client.path_rate / 1e6, 2)})
    p_before = client.progress
    client.set_exposure(1.0)
    n1 = client.preview_count
    time.sleep(args.exposure_wait)
    phases.append({"phase": "exposure_no_restart",
                   "ok": client.preview_count > n1 and client.progress >= p_before,
                   "progress_before": round(p_before, 5),
                   "progress_after": round(client.progress, 5)})
    client.set_env_rotation(90.0)
    restarted = wait(lambda: client.progress < p_before, RESTART_TIMEOUT, proc)
    phases.append({"phase": "env_rotation_restart", "ok": restarted,
                   "progress_after": round(client.progress, 5)})
    # Let the progress rise past its first step, so the swap's restart shows.
    p_restart = client.progress
    wait(lambda: client.progress > p_restart, RESTART_TIMEOUT, proc)
    p_swap = client.progress
    client.load_nif(str(_study.ROOT / "assets" / "nif_w256e16"))
    n2 = client.preview_count
    t2 = time.monotonic()
    seen = {"restart": False}

    def swapped():
        seen["restart"] = seen["restart"] or client.progress < p_swap
        return seen["restart"] and client.preview_count > n2 + 1

    ok = wait(swapped, SWAP_TIMEOUT, proc)
    phases.append({"phase": "load_nif_hot_swap", "ok": ok, "restart_seen": seen["restart"],
                   "resume_latency_s": round(time.monotonic() - t2, 2)})
    client.stop_render()
    rc = proc.wait(timeout=STOP_TIMEOUT)
    saved = (out / "probe.png").exists()
    phases.append({"phase": "remote_stop", "ok": rc == 0 and saved, "exit_code": rc,
                   "image_saved": saved})
    return phases


def main(argv=None) -> int:
    from ..ui.client import InterfaceClient

    ap = argparse.ArgumentParser(prog="ui_probe", description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--port", type=int, default=5179)
    ap.add_argument("--size", type=int, default=512, help="frame width (and height)")
    ap.add_argument("--height", type=int, default=None, help="frame height (default --size)")
    ap.add_argument("--samples-per-step", type=int, default=100)
    ap.add_argument("--interactive-samples", type=int, default=8)
    ap.add_argument("--window", type=float, default=20.0, help="preview-rate window (s)")
    ap.add_argument("--exposure-wait", type=float, default=5.0)
    ap.add_argument("--device-film", action="store_true")
    ap.add_argument("--denoise", action="store_true")
    args = ap.parse_args(argv)
    dev = _study.device_of(args.device, "ui_probe")
    out = _study.out_dir(args.out)
    cmd = [sys.executable, "-m", "ipu_path_trace_tpu_torch.runtime.cli",
           "-w", str(args.size), "-H", str(args.height or args.size), "-s", "200000",
           "--samples-per-step", str(args.samples_per_step),
           "--interactive-samples", str(args.interactive_samples),
           "--assets", str(_study.DEFAULT_ASSETS), "--ui-port", str(args.port),
           "-o", str(out / "probe.png"), "--device", args.device]
    cmd += ["--device-film"] * args.device_film + ["--denoise"] * args.denoise
    log_path = out / "cli.log"
    client = None
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=_study.ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + FIRST_TIMEOUT
            while client is None:
                try:
                    client = InterfaceClient("127.0.0.1", args.port, timeout=5)
                except OSError:
                    if time.monotonic() > deadline or proc.poll() is not None:
                        raise
                    time.sleep(0.5)
            phases = drive(client, proc, args, out)
        finally:
            if client is not None:
                client.close()
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    for p in phases:
        print(json.dumps(p), flush=True)
    secs = step_seconds(log_path.read_text())
    result = {"frame": [args.size, args.height or args.size], "samples_per_step": args.samples_per_step,
              "interactive_samples": args.interactive_samples, "device_film": args.device_film,
              "denoise": args.denoise, "phases": phases, "step_seconds": secs,
              "steps": slow_share(secs), "device": _study.card(dev)}
    _study.write_json(out, "ui_probe.json", result)
    print(json.dumps(result["steps"]))
    return 0 if all(p["ok"] for p in phases) else 1


if __name__ == "__main__":
    sys.exit(main())
