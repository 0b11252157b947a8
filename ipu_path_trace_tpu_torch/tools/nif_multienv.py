"""Multi-env stability of the on-class width rule, on the card.

Port of ``scripts/nif_multienv.py``: re-trains the rule-relevant
architectures (canonical 320 and the faster candidates) on further
synthetic urban-alley envs - other seeds of models/synth_env.py (default
13 and 23), which re-draw the skyline, facades, windows, emitters and sun
- with nif_reference_scale's matched recipe, scores each at the full frame
(K4, log-radiance PSNR), and reports per env whether a faster architecture
reaches the canonical's PSNR (the rule's verdict) and whether that verdict
is the same on every env checked.  Render rates depend on the
architecture only (nif_reference_scale measures them); none are measured
here.

    python -m ipu_path_trace_tpu_torch.tools.nif_multienv --out DIR [--seeds 13 23] \\
        [--archs 320 256 192 192e16] [--epochs 6000] [--batch-size 65536] \\
        [--size 2048x4096] [--device cuda|cpu]

writes ``DIR/nif_multienv.json`` (after every architecture); never
``docs/NIF_WIDTHS.json``.  Unlike the script it reads no earlier record:
the verdicts cover the envs of this run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from .nif_reference_scale import parse_arch, score, train_one

SECTION = "urban_alley_synth_multienv"


def verdicts(envs: dict[str, list[dict]]) -> dict:
    """Per env: the canonical PSNR, every 6-layer arch's, and the faster
    archs whose PSNR reaches the canonical's (the rule would ship one)."""
    out = {}
    for env_name, rows in envs.items():
        by_arch = {str(r["width"]) + (f"e{r['embedding_dim']}" if r.get("embedding_dim", 12)
                                      != 12 else ""): r["psnr_log_db"]
                   for r in rows if r.get("layers", 6) == 6}
        if "320" not in by_arch:
            continue
        canon = by_arch["320"]
        out[env_name] = {"canonical_psnr": canon, "others": by_arch,
                         "faster_archs_passing_rule": [a for a, q in by_arch.items()
                                                       if a != "320" and q >= canon]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nif_multienv")
    p.add_argument("--out", required=True, help="directory for nif_multienv.json")
    p.add_argument("--seeds", type=int, nargs="*", default=[13, 23])
    p.add_argument("--archs", nargs="*", default=["320", "256", "192", "192e16"])
    p.add_argument("--epochs", type=int, default=6000)
    p.add_argument("--batch-size", type=int, default=65536)
    p.add_argument("--size", default="2048x4096", help="HxW of each synthetic env")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    import torch

    from ..models.synth_env import resolve_synth
    from ..models.train_nif import check_device

    dev = check_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    envs: dict[str, list[dict]] = {}
    doc = {SECTION: {"description": "rule-stability check: the rule-relevant archs re-trained "
                                    "on independent synthetic urban-alley envs; matched "
                                    "recipe; full-frame PSNR",
                     "epochs": args.epochs,
                     "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                     "envs": envs}}
    for seed in args.seeds:
        env_name = f"synth:urban-alley:{args.size}:seed{seed}"
        t0 = time.monotonic()
        src = resolve_synth(env_name)
        print(f"env {env_name} generated in {time.monotonic() - t0:.0f}s, range "
              f"{src.min():.3g}..{src.max():.3g}", file=sys.stderr)
        rows = envs.setdefault(env_name, [])
        for arch in args.archs:
            width, embed, layers = parse_arch(arch)
            t0 = time.monotonic()
            weights, meta, loss = train_one(src, width, embed, layers, args.epochs,
                                            args.batch_size, env_name, dev)
            row = {"width": width, "psnr_log_db": round(score(weights, meta, src, dev), 2),
                   "final_loss": loss, "train_seconds": round(time.monotonic() - t0, 1)}
            if embed != 12:
                row["embedding_dim"] = embed
            if layers != 6:
                row["layers"] = layers
            rows.append(row)
            print(json.dumps({"env": env_name, **row}), flush=True)
            (out / "nif_multienv.json").write_text(json.dumps(doc, indent=2))
    v = verdicts(envs)
    for env_name, verdict in v.items():
        print(json.dumps({"env": env_name, **verdict}))
    stable = all(not x["faster_archs_passing_rule"] for x in v.values())
    doc[SECTION].update(verdicts=v, rule_choice_stable_across_envs=stable)
    print(json.dumps({"rule_choice_stable_across_envs": stable, "envs_checked": len(v)}))
    (out / "nif_multienv.json").write_text(json.dumps(doc, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
