"""Debug-visualisation save modes (``--debug-view``).

Counterpart of ``ipu_path_trace_tpu/film/debugview.py`` (NumPy, the
port's own copy).  A debug view replaces the Monte-Carlo radiance of the
saved image with a deterministic diagnostic channel, rendered through the
production camera and intersector by ``film/denoise.primary_features``
(the pixel-centre rays of the denoiser's guides).  The accumulator is
untouched: like ``--denoise``, the view changes only what is written to
``-o``.

Channels:
  normal       shading normal as RGB (n + 1) / 2; escaped pixels show the
               ray direction
  albedo       the demodulation guide: diffuse primary-hit colour, the env
               radiance along the centre ray for escaped pixels (HDR)
  depth        disparity 1 / (1 + t) as grey; sky = 0
  path-length  mean path length per pixel (pathLength / sampleCount of
               the live worklist) over max-path-length, grey
  escape-uv    R = u, G = v of the equirect lookup for escaped centre
               rays, zero on hits
"""

from __future__ import annotations

import numpy as np

DEBUG_VIEWS = ("normal", "albedo", "depth", "path-length", "escape-uv")


def mean_path_length(u, v, path_length, sample_count, width: int, height: int) -> np.ndarray:
    """(H, W) mean path length from per-record accumulators.

    Padding records (coords outside the image) and records without
    samples are skipped, as the film skips them.
    """
    u = np.asarray(u).astype(np.int64)
    v = np.asarray(v).astype(np.int64)
    pl = np.asarray(path_length).astype(np.float64)
    cnt = np.asarray(sample_count).astype(np.float64)
    ok = (u >= 0) & (u < width) & (v >= 0) & (v < height) & (cnt > 0)
    out = np.zeros((height, width), np.float32)
    mean = np.zeros(len(pl), np.float32)
    np.divide(pl, cnt, out=mean, where=cnt > 0, casting="unsafe")
    np.add.at(out, (v[ok], u[ok]), mean[ok])
    return out


def debug_view(mode: str, guides: dict, path_len_mean: np.ndarray | None = None,
               max_path_length: int = 10) -> np.ndarray:
    """(H, W, 3) float32 diagnostic image for ``mode``.

    ``guides`` holds NumPy arrays ``normal``, ``albedo``, ``disparity``,
    ``escape_uv`` and ``hit`` (``primary_features`` on the host);
    ``path_len_mean`` (from :func:`mean_path_length`) is needed for
    "path-length".  Every mode but albedo lies in [0, 1].
    """
    if mode not in DEBUG_VIEWS:
        raise ValueError(f"unknown debug view {mode!r}; choose from {DEBUG_VIEWS}")
    if mode == "normal":
        return (np.asarray(guides["normal"], np.float32) + 1.0) * 0.5
    if mode == "albedo":
        return np.asarray(guides["albedo"], np.float32)
    if mode == "depth":
        d = np.asarray(guides["disparity"], np.float32)
        return np.repeat(d[..., None], 3, axis=-1)
    if mode == "escape-uv":
        uv = np.asarray(guides["escape_uv"], np.float32)
        hit = np.asarray(guides["hit"], bool)
        img = np.zeros(uv.shape[:2] + (3,), np.float32)
        img[..., 0] = np.where(hit, 0.0, uv[..., 0])
        img[..., 1] = np.where(hit, 0.0, uv[..., 1])
        return img
    if path_len_mean is None:
        raise ValueError("path-length view needs the live worklist (path_len_mean); it is "
                         "only available in the render loop's save path")
    heat = np.asarray(path_len_mean, np.float32) / float(max(max_path_length, 1))
    return np.repeat(np.clip(heat, 0.0, 1.0)[..., None], 3, axis=-1)


def debug_ldr(img: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """uint8 PNG values of a debug image: clip, display gamma, round half
    up.  Exposure does not apply: the channels are not radiance."""
    x = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    x = x ** (1.0 / max(gamma, 1e-6))
    return (x * 255.0 + 0.5).astype(np.uint8)
