"""JSON scene descriptions (--scene).

Counterpart of ``ipu_path_trace_tpu/core/scenefile.py`` with the same
schema and the same error messages; the scene is built by the port's
``make_scene`` on the requested device.

Schema (all colours linear RGB; "emission" non-zero marks a light):

    {
      "objects": [
        {"type": "sphere", "center": [x, y, z], "radius": r,
         "colour": [r, g, b], "emission": [r, g, b],
         "material": "diffuse" | "specular" | "refractive"},
        {"type": "disc", "normal": [x, y, z], "center": [x, y, z],
         "radius": r, "colour": ..., "emission": ..., "material": ...}
      ]
    }

Object order in the file is preserved within each kind; spheres are
packed before discs (the Scene layout).  Intersection winners are
chosen by ray distance, so ordering only affects exact ties.
"""

from __future__ import annotations

import json
from typing import Any

from .scene import Material, Scene, make_scene

_MATERIALS = {
    "diffuse": Material.DIFFUSE,
    "specular": Material.SPECULAR,
    "refractive": Material.REFRACTIVE,
}


def _vec3(obj: dict, key: str, idx: int) -> tuple[float, float, float]:
    v = obj.get(key)
    if not isinstance(v, (list, tuple)) or len(v) != 3:
        raise ValueError(f"objects[{idx}].{key} must be a list of 3 numbers")
    try:
        return tuple(float(x) for x in v)
    except (TypeError, ValueError):
        # float(None)/float([]) raise TypeError, which would escape
        # load_scene's ValueError wrapper and lose the file/index context:
        raise ValueError(
            f"objects[{idx}].{key} must contain only numbers, got {v!r}")


def scene_from_dict(doc: dict[str, Any], device="cpu") -> Scene:
    objects = doc.get("objects")
    if not isinstance(objects, list) or not objects:
        raise ValueError("scene file needs a non-empty 'objects' list")

    spheres, discs = [], []
    attrs = {"sphere": [], "disc": []}  # (colour, emission, material) per kind
    for i, obj in enumerate(objects):
        kind = obj.get("type")
        if kind not in ("sphere", "disc"):
            raise ValueError(
                f"objects[{i}].type must be 'sphere' or 'disc', got {kind!r}"
            )
        mat_name = obj.get("material", "diffuse")
        if mat_name not in _MATERIALS:
            raise ValueError(
                f"objects[{i}].material must be one of {sorted(_MATERIALS)}, "
                f"got {mat_name!r}"
            )
        try:
            radius = float(obj.get("radius", 0.0))
        except (TypeError, ValueError):
            raise ValueError(
                f"objects[{i}].radius must be a number, "
                f"got {obj.get('radius')!r}")
        if radius <= 0.0:
            raise ValueError(f"objects[{i}].radius must be > 0")
        colour = _vec3(obj, "colour", i) if "colour" in obj else (1.0, 1.0, 1.0)
        emission = _vec3(obj, "emission", i) if "emission" in obj else (0.0, 0.0, 0.0)
        if kind == "sphere":
            spheres.append((_vec3(obj, "center", i), radius))
        else:
            discs.append((_vec3(obj, "normal", i), _vec3(obj, "center", i), radius))
        attrs[kind].append((colour, emission, _MATERIALS[mat_name]))

    ordered = attrs["sphere"] + attrs["disc"]  # Scene packs spheres first
    return make_scene(
        spheres=spheres,
        discs=discs,
        colours=[a[0] for a in ordered],
        emissions=[a[1] for a in ordered],
        materials=[a[2] for a in ordered],
        device=device,
    )


def load_scene(path: str, device="cpu") -> Scene:
    """Load a Scene from a JSON file (schema in module docstring); a file
    that cannot be read raises ValueError as a malformed one does."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except json.JSONDecodeError as e:
        raise ValueError(f"scene file '{path}' is not valid JSON: {e}") from e
    except OSError as e:
        raise ValueError(f"scene file '{path}' cannot be read: {e}") from e
    try:
        return scene_from_dict(doc, device)
    except ValueError as e:
        raise ValueError(f"scene file '{path}': {e}") from e
