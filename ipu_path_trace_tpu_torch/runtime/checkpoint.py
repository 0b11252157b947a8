"""Mid-render checkpoint and resume (``--checkpoint``, ``--resume``,
``--auto-resume``).

Counterpart of ``ipu_path_trace_tpu/runtime/checkpoint.py``.  The
progressive state goes to one ``.npz`` and a resumed render continues
bit for bit: the app replays the step-seed draws of the steps already
done (runtime/app.py), and accumulation keeps its order, so an
interrupted and resumed render writes the same EXR bytes as an
uninterrupted one (tests/test_torch_checkpoint.py).

Saved state by mode:

  ``hdr``   the host film's ``hdr`` (the sum over steps of each step's
            pixel means) at the last completed step
  ``soa``   the device film's worklist sums (u, v, r, g, b, sample_count,
            path_length; with ``--adaptive`` also lum2), int32 counts

With ``--enable-load-balancing`` (host film only) the file also holds
both double-buffer layouts, the (u, v) order of each buffer.  The re-deal
runs two buffers behind: after step N the active buffer holds the layout
step N+1 uploads and the inactive one the layout for step N+2, which the
host task has just dealt.  Restoring both continues the chain of layouts
bit for bit.

A fingerprint of every config field that changes the rendered numbers is
stored with the state; a resume under another one fails instead of
blending two renders.
"""

from __future__ import annotations

import json
import logging
import os
import zipfile

import numpy as np

log = logging.getLogger(__name__)

# Config fields that change the rendered values.  Presentation fields
# (exposure, gamma, outfile, save_interval, the observability flags) may
# differ between the two halves of a run.  "device" is the device type:
# a CPU render runs the plain versions, a CUDA one the kernels.
_FINGERPRINT_FIELDS = (
    "width", "height", "samples_per_step", "seed", "assets", "scene", "max_path_length",
    "aa_noise_type", "aa_noise_scale", "fov", "stop_prob", "roulette_depth",
    "refractive_index", "env_map_rotation", "aperture", "focal_distance", "nif_mode",
    "partials_type", "nif_precision", "env_skip", "use_fused_step", "device_film",
    "enable_load_balancing", "layout", "adaptive", "adaptive_min", "adaptive_max_factor",
    "sampler", "sobol_dims", "ipus", "mesh_shape",
)
# Fields added after checkpoints already existed: a saved fingerprint that
# predates the field matches only the value those checkpoints were
# rendered with (the reference's rule).
_FIELD_DEFAULTS = {"partials_type": "half", "ipus": 1, "mesh_shape": ""}
LAYOUT_KEYS = ("active_u", "active_v", "inactive_u", "inactive_v")

_FORMAT = 1
# What np.load and the reads of a member raise on a damaged file.
_UNREADABLE = (OSError, ValueError, EOFError, zipfile.BadZipFile)


def render_fingerprint(cfg) -> dict:
    """The numerics identity of a render."""
    fp = {f: getattr(cfg, f) for f in _FINGERPRINT_FIELDS}
    fp["device"] = str(cfg.device).split(":", 1)[0]
    if not fp["adaptive"]:  # the budget knobs are inert without --adaptive
        fp["adaptive_min"] = fp["adaptive_max_factor"] = None
    if fp["sampler"] == "prng":  # and the dimension count without Sobol
        fp["sobol_dims"] = None
    return fp


def save_checkpoint(path: str, cfg, step: int, *, hdr: np.ndarray | None = None,
                    soa: dict[str, np.ndarray] | None = None,
                    layouts: dict[str, np.ndarray] | None = None,
                    fingerprint: dict | None = None) -> None:
    """Write the progressive state at completed step ``step``: exactly
    one of ``hdr`` (host film) and ``soa`` (device film), and the load
    balancer's ``layouts`` where it runs.  ``fingerprint`` is the one
    taken when the step was dispatched (default: ``cfg``'s now).  Written
    to a temporary file and renamed, so an interrupt mid-write leaves the
    previous checkpoint whole."""
    if (hdr is None) == (soa is None):
        raise ValueError("pass exactly one of hdr= or soa=")
    meta = {"format": _FORMAT, "step": int(step), "mode": "soa" if soa is not None else "hdr",
            "fingerprint": fingerprint if fingerprint is not None else render_fingerprint(cfg)}
    arrays = {"meta": np.frombuffer(json.dumps(meta).encode(), np.uint8)}
    if hdr is not None:
        arrays["hdr"] = np.asarray(hdr, np.float32)
    else:
        arrays.update({f"soa_{k}": np.asarray(a) for k, a in soa.items()})
    arrays.update({f"layout_{k}": np.asarray(a) for k, a in (layouts or {}).items()})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    log.info("Checkpoint written at step %d -> '%s'", step, path)


def load_checkpoint(path: str, cfg) -> tuple[int, str, dict]:
    """(completed step, mode, state) after the fingerprint check.
    ``state`` holds "hdr" or the SoA arrays by name, and "layouts"."""
    try:
        z = np.load(path)
    except _UNREADABLE as e:
        raise ValueError(f"checkpoint '{path}' is unreadable: {e}") from e
    with z:
        try:
            meta = json.loads(z["meta"].tobytes().decode())
            step, mode, got = int(meta["step"]), meta["mode"], meta["fingerprint"]
            fmt = meta["format"]
        except (KeyError, TypeError, *_UNREADABLE) as e:
            raise ValueError(f"checkpoint '{path}' has no valid metadata: {e}") from e
        if fmt != _FORMAT:
            raise ValueError(f"checkpoint '{path}' has format {fmt}, expected {_FORMAT}")
        want = render_fingerprint(cfg)
        got = {**_FIELD_DEFAULTS, **got}
        diffs = {k: (got.get(k), want[k]) for k in want if got.get(k) != want[k]}
        if diffs:
            raise ValueError("checkpoint does not match this render configuration "
                             f"(checkpoint vs current): {diffs}")
        try:
            if mode == "hdr":
                state = {"hdr": z["hdr"]}
            elif mode == "soa":
                state = {k[len("soa_"):]: z[k] for k in z.files if k.startswith("soa_")}
            else:
                raise ValueError(f"unknown mode {mode!r}")
            state["layouts"] = {k[len("layout_"):]: z[k] for k in z.files
                                if k.startswith("layout_")}
        except (KeyError, *_UNREADABLE) as e:
            raise ValueError(f"checkpoint '{path}' is corrupt: {e}") from e
    return step, mode, state
