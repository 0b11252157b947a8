"""The readings the limits are set from, on the card at each cell's own size.

For each seed, one run of the harness with a short window: the program's
numbers (the lower readings) and, on the first seeds, the control's: the
plain reference in fp8 (e4m3 operands, one step below the configuration's
bf16) put in the program's place, compared with the reference in bf16 as
the program is (the upper readings).  The program must be within every
limit on every seed, and the control past the ``rgb_rel_l1`` limit on
every seed it ran.

    python3 -m pytest port_bench/tests/test_port_bench_control.py -m card

``PORT_BENCH_CELLS`` (comma-separated) picks cells, ``PORT_BENCH_SEEDS`` the
number of seeds (12), ``PORT_BENCH_CONTROL_SEEDS`` how many of them also run
the control (3), ``PORT_BENCH_SECONDS`` the window (4); with
``PORT_BENCH_OUT`` every reading is appended there as a JSON line.  A cell
that needs more cards than there are skips.
"""

import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from port_bench import run  # noqa: E402
from port_bench.cells import load_cell, load_json  # noqa: E402

CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]
FIRST_SEED = 3_000_000_017  # past 2**31, as a run's --seed may be


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_within_limits_and_control_past_them(cell, cuda):
    import torch

    wanted = os.environ.get("PORT_BENCH_CELLS")
    if wanted and cell not in wanted.split(","):
        pytest.skip("not among PORT_BENCH_CELLS")
    c = load_cell(cell)
    if torch.cuda.device_count() < c.chips:
        pytest.skip(f"needs {c.chips} cards")
    seeds = int(os.environ.get("PORT_BENCH_SEEDS", 12))
    controls = int(os.environ.get("PORT_BENCH_CONTROL_SEEDS", 3))
    seconds = float(os.environ.get("PORT_BENCH_SECONDS", 4))
    out = os.environ.get("PORT_BENCH_OUT")
    failed = []
    for k in range(seeds):
        seed = FIRST_SEED + 7919 * k
        res = run.run_cell(c, seed, seconds, False, control=k < controls)
        line = {"cell": cell, "seed": seed, "steps": res["attempted"],
                "program": {n: v["value"] for n, v in res["checks"].items()},
                "control": res.get("checks_control"), "correct": res["correct"]}
        print(json.dumps(line), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(line) + "\n")
        if not res["correct"]:
            failed.append(("program", seed, line["program"]))
        ctl = res.get("checks_control")
        if k < controls and not (ctl and ctl["rgb_rel_l1"] > c.limits["rgb_rel_l1"]):
            failed.append(("control", seed, ctl))
    assert not failed, failed
