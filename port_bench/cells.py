"""A cell of the benchmark: its entry in BENCHMARK.json, found by name, with
its configuration file, its traffic file and its limits file.

Everything that belongs to one configuration, one traffic mix or one
cell is data under ``port_bench/``: ``configs/<file>`` (named by the
configuration's ``file`` in BENCHMARK.json), ``traffic/<mix>.json`` and
``limits/<cell>.json``.  ``app_config`` turns a cell into the keyword
arguments of the renderer's ``runtime/config.Config``, as its command
line would set them.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Steps a run could take before it ran out of samples: never reached, the
# window ends through the stop flag.
NEVER_ENDS = 10 ** 6
# A configuration's ``nif_precision`` (the chain's type, the one key that
# states it) as the app's two flags: (--nif-precision, --partials-type).
APP_PRECISION = {"bf16": ("auto", "half"), "int8": ("int8", "half"), "tf32": ("auto", "float")}


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(work)})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _reported(m, name)],
                [m for m in bench["per_layer"] if _reported(m, name)])


def app_config(cell: Cell, seed: int, out_dir: str, device: str) -> dict:
    """The renderer's Config fields for one run of the cell: its size,
    asset, scene and chain, the traffic's step, and an exit save and a
    checkpoint (the final state the check reads) in ``out_dir``."""
    c, t = cell.config, cell.traffic
    spp = int(t["samples_per_step"])
    if c["nif_precision"] not in APP_PRECISION:
        raise ValueError(f"unknown nif_precision {c['nif_precision']!r} "
                         f"({', '.join(APP_PRECISION)})")
    nif_precision, partials_type = APP_PRECISION[c["nif_precision"]]
    kw = dict(
        outfile=os.path.join(out_dir, "render.png"), checkpoint=os.path.join(out_dir, "state.npz"),
        width=int(c["width"]), height=int(c["height"]), samples=spp * NEVER_ENDS,
        samples_per_step=spp, save_interval=int(t["save_interval"]), seed=int(seed),
        assets=str(ROOT / c["asset"]), scene=str(ROOT / c["scene"]) if c["scene"] else "",
        fov=float(c["fov"]), max_path_length=int(c["max_path_length"]),
        aa_noise_type=c["aa_noise_type"], layout=c["layout"], partials_type=partials_type,
        nif_precision=nif_precision, nif_mode=c["nif_mode"], env_skip=t["env_skip"],
        device_film=bool(t["device_film"]), sampler=t["sampler"], adaptive=bool(t["adaptive"]),
        ipus=int(t["ipus"]), mesh_shape=t["mesh_shape"], device=device, log_level="info")
    if t["adaptive"]:
        kw.update(adaptive_min=int(t["adaptive_min"]),
                  adaptive_max_factor=float(t["adaptive_max_factor"]))
    return kw
