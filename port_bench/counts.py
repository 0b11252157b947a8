"""The yardstick's arithmetic: the work a window's paths need, and the
card's peaks.

Operations are counted from what the inputs need, not from what a kernel
does: one NIF evaluation for each path that escapes (the configuration's
``escape_share``, measured once by the plain reference), twice the
chain's multiply-adds each (the layer widths of the configuration file,
the encode width and the skip input included).  Bytes: each input of a
megastep launch read once and each output written once.

Peaks of one NVIDIA H100 SXM (the data sheet's dense rates at its
700 W limit): 989 TFLOP/s bf16, 1,979 TOP/s int8 and fp8, 495 TFLOP/s
tf32, 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp8": 1979e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
ELEMENT_BYTES = {"bf16": 2, "int8": 1, "fp8": 1, "tf32": 4, "f32": 4}
SCENE_FLOATS = {"sphere": 12, "disc": 15}
BUDGET_BLOCK = 2048


def chain_macs(config: dict) -> int:
    """Multiply-adds of one NIF evaluation: the sum of fan-in x fan-out."""
    return sum(int(i) * int(o) for i, o in config["layers"])


def nif_ops(config: dict, paths: int) -> float:
    """Operations the NIF chain needs for ``paths`` camera paths."""
    return 2.0 * chain_macs(config) * paths * float(config["escape_share"])


def weight_bytes(config: dict) -> int:
    return ELEMENT_BYTES[config["nif_precision"]] * sum(int(i) * int(o) + int(o)
                                                for i, o in config["layers"])


def k3_bytes(config: dict, traffic: dict, records: int, launches: int) -> float:
    """Bytes the window's megastep launches must move: per record its
    pixel (2 x 4 B) in, its radiance (3 x 4 B) and path length (4 B) out,
    and its squared-luminance sum (4 B) out in the adaptive step; per
    launch the weights, the scene's tables and, adaptive, the budgets."""
    per_record = 8 + 16 + (4 if traffic["adaptive"] else 0)
    objects = config.get("scene_objects", {"sphere": 5, "disc": 1})
    per_launch = weight_bytes(config) + 4 * sum(SCENE_FLOATS[k] * n for k, n in objects.items())
    if traffic["adaptive"]:
        per_launch += 4 * -(-records // max(launches, 1) // BUDGET_BLOCK)
    return float(per_record * records + per_launch * launches)


def k3_least_seconds(config: dict, traffic: dict, paths: int, records: int,
                     launches: int) -> tuple[float, str]:
    """The least time one card could take for the window's megastep work,
    and what bounds it ("ops" or "bytes")."""
    t_ops = nif_ops(config, paths) / PEAK_OPS[config["nif_precision"]]
    t_bytes = k3_bytes(config, traffic, records, launches) / PEAK_BYTES
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
