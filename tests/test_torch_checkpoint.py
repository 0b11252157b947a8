"""The port's pipelined loop, checkpoint/resume and graceful stop, on the CPU.

A resumed render writes the uninterrupted render's EXR byte for byte
(host film, device film, device film + adaptive, load balancing); a
checkpoint of another configuration, a corrupt one and one without the
load balancer's layouts are refused; the pipelined CLI writes the EXR of
a serial loop of render_step and the plain film; a SIGTERM mid-render
ends in the exit path with exit code 0.  Counterpart of the JAX
package's tests/test_checkpoint.py.
"""

import dataclasses
import json
import queue
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from ipu_path_trace_tpu_torch.core.records import from_device_batch, to_device_batch
from ipu_path_trace_tpu_torch.film.film import Film
from ipu_path_trace_tpu_torch.film.imageio import read_exr, save_images
from ipu_path_trace_tpu_torch.render.wavefront import render_step
from ipu_path_trace_tpu_torch.runtime import cli
from ipu_path_trace_tpu_torch.runtime.app import PathTracerApp, step_seed
from ipu_path_trace_tpu_torch.runtime.checkpoint import (load_checkpoint, render_fingerprint,
                                                         save_checkpoint)
from ipu_path_trace_tpu_torch.runtime.config import Config

ROOT = Path(__file__).resolve().parents[1]
NIF = str(ROOT / "assets" / "urban_alley_synth_nif")
BASE = dict(assets="constant:0.8,0.7,0.6", width=32, height=24, samples=8, samples_per_step=2,
            save_interval=2, seed=5, max_path_length=4, device="cpu")
# (config, steps of the first half): the first half ends on a save step of
# the host film, between intervals on the device film (its exit path
# fetches the dirty film) and under load balancing (mid re-deal chain).
MODES = {
    "host film": ({}, 2),
    "device film": (dict(device_film=True), 3),
    "device film adaptive": (dict(device_film=True, adaptive=True, adaptive_min=1, assets=NIF,
                                  samples=4, env_skip="off"), 1),
    "load balancing": (dict(enable_load_balancing=True), 3),
}


def _cfg(tmp_path, tag, **kw):
    return Config(**{**BASE, "outfile": str(tmp_path / f"{tag}.png"), **kw})


def _run(cfg, max_steps=None) -> Film:
    app = PathTracerApp(cfg)
    app.init()
    app.build()
    return app.execute(max_steps=max_steps)


def _exr(cfg) -> bytes:
    return Path(cfg.outfile).with_suffix(".exr").read_bytes()


@pytest.mark.parametrize("mode", MODES)
def test_resume_is_bitwise(tmp_path, mode):
    """N steps straight == k steps + checkpoint + resume: the same EXR bytes."""
    kw, first = MODES[mode]
    full = _cfg(tmp_path, "full", **kw)
    _run(full)
    ck = str(tmp_path / "state.npz")
    half = _cfg(tmp_path, "a", checkpoint=ck, **kw)
    _run(half, max_steps=first)
    step, saved_mode, state = load_checkpoint(ck, half)
    assert step == first and saved_mode == ("soa" if half.device_film else "hdr")
    assert bool(state["layouts"]) == half.enable_load_balancing
    if half.adaptive:
        assert "lum2" in state
    resumed = _cfg(tmp_path, "b", resume=ck, **kw)
    _run(resumed)
    assert _exr(resumed) == _exr(full)
    assert Path(resumed.outfile).exists()


def test_auto_resume_with_and_without_a_file(tmp_path):
    ck = tmp_path / "auto.npz"
    full = _cfg(tmp_path, "full")
    _run(full)
    auto = _cfg(tmp_path, "auto", checkpoint=str(ck), auto_resume=True)
    _run(auto, max_steps=2)  # no file yet: starts afresh and writes one
    assert load_checkpoint(str(ck), auto)[0] == 2
    _run(auto)  # the same command again resumes from it
    assert _exr(auto) == _exr(full)
    assert load_checkpoint(str(ck), auto)[0] == 4


def test_checkpoint_written_at_exit_between_intervals(tmp_path):
    """Three steps with --save-interval 2: the exit path checkpoints step
    3 and saves the image of step 3."""
    ck = str(tmp_path / "exit.npz")
    cfg = _cfg(tmp_path, "exit", checkpoint=ck)
    film = _run(cfg, max_steps=3)
    step, mode, state = load_checkpoint(ck, cfg)
    assert (step, mode) == (3, "hdr")
    np.testing.assert_array_equal(state["hdr"], film.hdr)
    np.testing.assert_array_equal(read_exr(str(tmp_path / "exit.exr")), film.hdr_at_step(3))


@pytest.mark.parametrize("field,value", [
    ("seed", 6), ("device", "cuda"), ("use_fused_step", False), ("nif_precision", "int8"),
    ("env_skip", "on"), ("layout", "raster"), ("enable_load_balancing", True),
    ("samples_per_step", 4), ("sampler", "sobol")])
def test_fingerprint_mismatch_is_refused(tmp_path, field, value):
    cfg = _cfg(tmp_path, "fp")
    ck = str(tmp_path / "fp.npz")
    save_checkpoint(ck, cfg, 1, hdr=np.zeros((24, 32, 3), np.float32))
    with pytest.raises(ValueError, match="does not match"):
        load_checkpoint(ck, dataclasses.replace(cfg, **{field: value}))
    # Knobs that are inert in this render do not count:
    load_checkpoint(ck, dataclasses.replace(cfg, adaptive_min=3, sobol_dims=8))


def test_partials_float_resume_is_bitwise(tmp_path):
    """A --partials-type float render (the f32 NIF chain) resumes bit for
    bit: 2 + 2 steps write the 4-step render's EXR bytes."""
    kw = dict(assets=NIF, partials_type="float", samples=8, env_skip="off")
    full = _cfg(tmp_path, "full", **kw)
    _run(full)
    ck = str(tmp_path / "f32.npz")
    _run(_cfg(tmp_path, "a", checkpoint=ck, **kw), max_steps=2)
    assert load_checkpoint(ck, _cfg(tmp_path, "a", **kw))[0] == 2
    resumed = _cfg(tmp_path, "b", resume=ck, **kw)
    _run(resumed)
    assert _exr(resumed) == _exr(full)


@pytest.mark.parametrize("saved,resumed", [("half", "float"), ("float", "half")])
def test_partials_type_mismatch_is_refused(tmp_path, saved, resumed):
    ck = str(tmp_path / "pt.npz")
    cfg = _cfg(tmp_path, "pt", partials_type=saved)
    save_checkpoint(ck, cfg, 1, hdr=np.zeros((24, 32, 3), np.float32))
    with pytest.raises(ValueError, match="partials_type"):
        load_checkpoint(ck, dataclasses.replace(cfg, partials_type=resumed))
    assert load_checkpoint(ck, cfg)[0] == 1


def test_fingerprint_without_partials_type_matches_half_only(tmp_path):
    """A checkpoint saved before the fingerprint had partials_type was a
    half (bf16) render: it resumes a half render and refuses a float one."""
    ck = str(tmp_path / "old.npz")
    cfg = _cfg(tmp_path, "old")
    fp = {k: v for k, v in render_fingerprint(cfg).items() if k != "partials_type"}
    save_checkpoint(ck, cfg, 2, hdr=np.zeros((24, 32, 3), np.float32), fingerprint=fp)
    assert load_checkpoint(ck, cfg)[0] == 2
    with pytest.raises(ValueError, match="partials_type"):
        load_checkpoint(ck, dataclasses.replace(cfg, partials_type="float"))


def test_resume_refuses_another_render(tmp_path):
    ck = str(tmp_path / "other.npz")
    _run(_cfg(tmp_path, "a", checkpoint=ck), max_steps=2)
    with pytest.raises(ValueError, match="does not match"):
        _run(_cfg(tmp_path, "b", resume=ck, seed=6))
    assert not (tmp_path / "b.png").exists()


def _corrupt(path: Path, how: str, cfg) -> None:
    save_checkpoint(str(path), cfg, 2, hdr=np.zeros((24, 32, 3), np.float32))
    data = path.read_bytes()
    if how == "garbage":
        path.write_bytes(b"not a checkpoint at all" * 10)
    elif how == "truncated":
        path.write_bytes(data[: len(data) // 2])
    else:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        if how == "no meta":
            del arrays["meta"]
        elif how == "bad meta":
            arrays["meta"] = np.frombuffer(b"{not json", np.uint8)
        elif how == "old format":
            meta = json.loads(arrays["meta"].tobytes())
            arrays["meta"] = np.frombuffer(json.dumps({**meta, "format": 0}).encode(), np.uint8)
        elif how == "no state":
            del arrays["hdr"]
        np.savez(path, **arrays)


@pytest.mark.parametrize("how", ["garbage", "truncated", "no meta", "bad meta", "old format",
                                 "no state"])
def test_corrupt_checkpoint_is_refused(tmp_path, how):
    cfg = _cfg(tmp_path, "bad")
    ck = tmp_path / "bad.npz"
    _corrupt(ck, how, cfg)
    with pytest.raises(ValueError, match="checkpoint"):
        load_checkpoint(str(ck), cfg)


def test_load_balancing_resume_needs_the_layouts(tmp_path):
    """A load-balancing checkpoint without the two layouts cannot seed
    the re-deal chain: the resume refuses it before rendering."""
    cfg = _cfg(tmp_path, "lb", enable_load_balancing=True)
    ck = str(tmp_path / "lb.npz")
    save_checkpoint(ck, cfg, 1, hdr=np.zeros((24, 32, 3), np.float32))
    with pytest.raises(ValueError, match="no load-balancer layouts"):
        _run(dataclasses.replace(cfg, resume=ck))
    assert not (tmp_path / "lb.png").exists()


@pytest.mark.parametrize("assets,spp", [("constant:0.8,0.7,0.6", 8), (NIF, 4)],
                         ids=["constant", "nif"])
def test_pipelined_cli_equals_serial_loop(tmp_path, assets, spp):
    """The CLI's EXR (host task, native film) is byte for byte that of a
    serial loop of render_step, fetch and the plain film on the same seeds."""
    argv = ["-w", "32", "-H", "24", "-s", str(spp), "--samples-per-step", "2",
            "--max-path-length", "4", "--seed", "5", "--assets", assets, "--device", "cpu",
            "--save-interval", "3", "--env-skip", "off", "-o", str(tmp_path / "cli.png")]
    assert cli.main(argv) == 0
    cfg = cli.parse_config(argv[:-1] + [str(tmp_path / "serial.png")])
    app = PathTracerApp(cfg)
    app.init()
    app.build()
    settings, static = app.settings(), app.static_config()
    work = to_device_batch(app.worklist, "cpu")
    gen = torch.Generator().manual_seed(cfg.seed)
    film = Film(cfg.width, cfg.height, native=False)
    steps = spp // cfg.samples_per_step
    for step in range(1, steps + 1):
        out = render_step(app.scene, settings, static, work, step_seed(gen), app.env,
                          sobol_base=(step - 1) * cfg.samples_per_step)
        film.accumulate(from_device_batch(out))
    save_images(cfg.outfile, film.hdr_at_step(steps), film.ldr(steps, cfg.exposure, cfg.gamma))
    assert (tmp_path / "cli.exr").read_bytes() == (tmp_path / "serial.exr").read_bytes()


def test_sigterm_mid_render_takes_the_exit_path(tmp_path):
    """A SIGTERM after step 2 of 48 ends the render after the step in
    flight: exit code 0, the checkpoint of the last step done and the
    image of it on disk."""
    ck, out = tmp_path / "term.npz", tmp_path / "term.png"
    argv = ["-w", "32", "-H", "24", "-s", "48", "--samples-per-step", "1",
            "--max-path-length", "4", "--seed", "5", "--assets", "constant:0.8,0.7,0.6",
            "--device", "cpu", "--save-interval", "1000", "--checkpoint", str(ck), "-o", str(out)]
    proc = subprocess.Popen([sys.executable, "-m", "ipu_path_trace_tpu_torch.runtime.cli", *argv],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    log = []
    try:
        while not any("Completed render step 2/48" in ln for ln in log):
            log.append(lines.get(timeout=120))
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        proc.kill()
    reader.join(timeout=10)
    while not lines.empty():
        log.append(lines.get())
    text = "".join(log)
    assert rc == 0, text
    assert "Received signal 15" in text and "Stop requested" in text
    cfg = cli.parse_config(argv)
    step, mode, state = load_checkpoint(str(ck), cfg)
    assert mode == "hdr" and 2 <= step < 48
    assert f"Saved images at exit (step {step})" in text
    np.testing.assert_array_equal(read_exr(str(tmp_path / "term.exr")),
                                  state["hdr"] * (1.0 / step))
    assert out.exists()
