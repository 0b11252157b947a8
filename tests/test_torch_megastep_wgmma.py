"""The host side of K3 on the wgmma chains (csrc/megastep.cuh
megastep_wg_kernel), and a CPU model of its bf16 tiles against the JAX
package (the int8 tiles: tests/test_torch_int8_wgmma.py).

The kernel needs an H100 (chip_smoke.py holds it against its plain version
there and reads HGMMA, no HMMA, in its SASS).  What the CPU checks is what
the kernel is given and what its geometry computes:
  * K3's shared-memory plan (ops/megastep.megastep_wg_plan) on every bf16
    asset: it fits the 232,448 B a block may use, with 3 ring stages for
    the canonical net on the default scene, the enclosed scene of
    tests/test_torch_envskip.py and the shipped JSON scenes; its stage count
    follows the scene's table bytes by formula, and a scene whose tables
    leave no room for 2 stages raises, naming the limit;
  * the budget contract: a budget block is whole CUDA blocks, and a CUDA
    block two 128-ray wgmma tiles;
  * the chain selector: a bf16 model's NifWg and an int8 model's NifWg,
    each with K3's plan; any other struct is refused;
  * the env-skip tile: 128 rays for both chains, as the app's auto probe
    logs it;
  * the kernel's arithmetic from its operands - per 256-ray block its
    budget of samples, per sample the trace and then the two 128-ray tiles
    through the chain of the swizzled slices (test_torch_nif_wgmma), a tile
    skipped where no ray of it escapes or none is live - against the
    reference composition (tests/test_megastep.py::_xla_twin) with that
    test's tolerance, and with the env-skip on equal to off bit for bit.
"""

import json
import logging
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_megastep import MAXLEN, SAMPLES, H, W, _setup, _xla_twin
from test_torch_envskip import ENCLOSED
from test_torch_megastep import assert_matches_twin
from test_torch_nif_wgmma import _chain_from_slices

from ipu_path_trace_tpu.models import nif as jnif
from ipu_path_trace_tpu_torch.core.scene import default_scene
from ipu_path_trace_tpu_torch.core.scenefile import load_scene, scene_from_dict
from ipu_path_trace_tpu_torch.models import nif
from ipu_path_trace_tpu_torch.models.quant import quantize_nif
from ipu_path_trace_tpu_torch.ops import _lib, megastep, trace
from ipu_path_trace_tpu_torch.ops import nif as nif_ops
from ipu_path_trace_tpu_torch.ops.nif import equirect_from_dir
from ipu_path_trace_tpu_torch.render.params import RenderSettings
from ipu_path_trace_tpu_torch.runtime import cli

ASSETS = Path(__file__).resolve().parent.parent / "assets"
# Every NIF asset in assets/ but the int8 one (its quant_amax.json).
BF16_ASSETS = sorted(p.name for p in ASSETS.iterdir()
                     if (p / "converted.hdf5").exists() and not (p / "quant_amax.json").exists())
CANONICAL = "urban_alley_synth_nif"
SCENES = {"default": default_scene, "enclosed": lambda: scene_from_dict(ENCLOSED),
          **{p.stem: (lambda p=p: load_scene(str(p)))
             for p in sorted((ASSETS / "scenes").glob("*.json"))}}
LIMIT = 232_448  # shared memory a block may use (csrc/nif_wgmma.cuh kWgSmemLimit)
# csrc/megastep.cuh: (u, v) of 256 rays, 3 x 256 head outputs, the control word.
TAIL = 2 * 256 * 4 + 3 * 256 * 4 + 16


def _load(name):
    return nif.load_nif_assets(str(ASSETS / name))[0]


def _spheres(count):
    """A scene of `count` small diffuse spheres in a row."""
    return scene_from_dict({"objects": [
        {"type": "sphere", "center": [0.1 * i, 0.0, -5.0], "radius": 0.05}
        for i in range(count)]})


def test_every_bf16_asset_is_listed():
    assert CANONICAL in BF16_ASSETS and len(BF16_ASSETS) == 7
    assert "urban_alley_synth_nif_int8" not in BF16_ASSETS


@pytest.mark.parametrize("scene_name", sorted(SCENES))
@pytest.mark.parametrize("asset", BF16_ASSETS)
def test_plan_fits_a_block(asset, scene_name):
    """The plan stays within 227 KB with at least 3 stages (exactly 3 for
    the canonical net), its pieces in order: the chain's (1024-aligned)
    and, from smem_uv on, K3's tail, then the scene's tables as
    csrc/megastep.cuh::mega_tables_offset places them, then the slack."""
    model, scene = _load(asset), SCENES[scene_name]()
    plan = megastep.megastep_wg_plan(model, scene)
    chain = nif_ops.wgmma_plan(model)
    tables = megastep.table_bytes(scene)
    assert plan["smem_bytes"] <= LIMIT
    assert plan["stages"] >= 3
    if asset == CANONICAL:
        assert plan["stages"] == 3
    for key in ("layers", "act_atoms", "feat_atoms", "stage_bytes", "smem_feat", "smem_ring"):
        assert plan[key] == chain[key], key
    assert plan["smem_bar"] == plan["smem_ring"] + plan["stages"] * plan["stage_bytes"]
    assert plan["smem_uv"] == plan["smem_bar"] + 64
    assert plan["smem_tables"] == plan["smem_uv"] + TAIL
    assert megastep.MEGA_TAIL_BYTES == TAIL
    assert plan["smem_bytes"] == plan["smem_tables"] + -(-tables // 16) * 16 + 1024
    assert plan["smem_tables"] % 16 == 0 and plan["smem_bar"] % 1024 == 0
    # As many stages as fit: one more would not.
    assert plan["smem_bytes"] + plan["stage_bytes"] > LIMIT or plan["stages"] == 4


def test_canonical_default_plan_bytes():
    """The plan csrc/megastep.cuh's comment states: 3 stages, 227,712 B."""
    plan = megastep.megastep_wg_plan(_load(CANONICAL), default_scene())
    assert megastep.table_bytes(default_scene()) == 300
    assert (plan["stages"], plan["smem_uv"], plan["smem_tables"], plan["smem_bytes"]) == (
        3, 221_248, 226_384, 227_712)


@pytest.mark.parametrize("count, stages", [(1, 3), (105, 3), (106, 2), (958, 2), (959, None),
                                           (1000, None)])
def test_stages_follow_the_tables(count, stages):
    """Stages by formula: 3 while the tables take at most 5,040 B (105
    spheres, 5,040 B), 2 up to 46,000 B (958 spheres, 45,984 B), and past
    that the plan raises, naming the limit."""
    model, scene = _load(CANONICAL), _spheres(count)
    if stages is None:
        with pytest.raises(ValueError, match=f"megastep's bf16 chain.*a block has {LIMIT}"):
            megastep.megastep_wg_plan(model, scene)
        with pytest.raises(ValueError, match="shared memory"):  # the launch path: no fallback
            megastep.kernel_net(model, scene)
    else:
        assert megastep.megastep_wg_plan(model, scene)["stages"] == stages


def test_budget_and_tile_contract():
    assert megastep.BUDGET_BLOCK % megastep.RAYS_PER_CUDA_BLOCK == 0
    assert megastep.RAYS_PER_CUDA_BLOCK % nif_ops.WG_RAYS == 0
    assert megastep.RAYS_PER_CUDA_BLOCK == 2 * nif_ops.WG_RAYS == 256
    assert megastep.RAYS_PER_CUDA_BLOCK % megastep.ENV_SKIP_TILE == 0


@pytest.mark.parametrize("asset", BF16_ASSETS)
def test_kernel_nets_pick_the_chain(asset):
    """A bf16 model and its int8 quantization each get a NifWg carrying
    K3's plan (not K2's) for their chain; the launcher's argument refuses
    anything but a NifWg."""
    model = _load(asset)
    _, meta, weights = nif.load_nif_assets(str(ASSETS / asset))
    q8 = quantize_nif(weights, meta)
    for m, int8 in ((model, 0), (q8, 1)):
        wg = megastep.kernel_net(m, default_scene())
        plan = megastep.megastep_wg_plan(m, default_scene())
        assert isinstance(wg, _lib.NifWg) and wg.int8 == int8 and plan["elem"] == 2 - int8
        assert (wg.stages, wg.smem_bar, wg.smem_uv, wg.smem_bytes) == (
            plan["stages"], plan["smem_bar"], plan["smem_uv"], plan["smem_bytes"])
        assert plan["smem_bytes"] != nif_ops.wgmma_plan(m)["smem_bytes"]
        assert [wg.w[i] for i in range(wg.num_layers)] == [
            w.data_ptr() for w, _ in nif_ops.wgmma_operands(m)]
        assert nif_ops.wg_arg(wg)._obj is wg
    for bad in (_lib.TraceParams(), None, (None, wg)):
        with pytest.raises(ValueError, match="NifWg"):
            nif_ops.wg_arg(bad)


def test_f32_model_is_refused():
    model = nif.load_nif_assets(str(ASSETS / CANONICAL), torch.float32)[0]
    with pytest.raises(ValueError, match="bf16"):
        megastep.kernel_net(model, default_scene())


@pytest.mark.parametrize("asset", BF16_ASSETS)
def test_env_skip_tile_by_chain(asset):
    """Both chains run K3's 128-ray wgmma tiles, so the env-skip tile (the
    guard's granularity, at which the app's auto probe measures) is 128 for
    either."""
    model = _load(asset)
    _, meta, weights = nif.load_nif_assets(str(ASSETS / asset))
    assert megastep.ENV_SKIP_TILE == nif_ops.WG_RAYS == 128
    for m in (model, quantize_nif(weights, meta)):
        assert megastep.kernel_net(m, default_scene()).num_layers == m.num_layers


@pytest.mark.parametrize("asset, flags, tile", [
    (CANONICAL, [], 128),
    ("urban_alley_synth_nif_int8", ["--nif-precision", "int8"], 128),
])
def test_cli_probe_uses_the_chains_tile(tmp_path, caplog, asset, flags, tile):
    """--env-skip auto measures at the tile of the model's kernel."""
    (tmp_path / "enclosed.json").write_text(json.dumps(ENCLOSED))
    with caplog.at_level(logging.INFO):
        assert cli.main(["-w", "16", "-H", "16", "-s", "1", "--samples-per-step", "1",
                         "--max-path-length", "3", "--assets", str(ASSETS / asset),
                         "-o", str(tmp_path / "x.png"), "--device", "cpu",
                         "--scene", str(tmp_path / "enclosed.json"), *flags]) == 0
    lines = [r.getMessage() for r in caplog.records if "--env-skip auto" in r.getMessage()]
    assert len(lines) == 1 and f"at block {tile} " in lines[0] and lines[0].endswith("-> on")


def _k3_tiles(model, scene, settings, cols, rows, noise, budgets=None, budget_block=256,
              env_skip=False):
    """The bf16 K3's arithmetic on the CPU, from its operands: per 256-ray
    block its budget of samples (all S without budgets); per sample the
    plain trace on the host noise, then each block's two 128-ray tiles
    through the chain of the swizzled slices, a tile skipped where none of
    its rays is live or (env_skip) none escapes; direct + the bgr -> rgb
    env term times the escape weights, summed.  (3, P) and (P,)."""
    p = cols.shape[0]
    blocks = -(-p // 256)
    rad = torch.zeros(3, blocks * 256)
    plen = torch.zeros(blocks * 256, dtype=torch.int64)
    lane_budget = (torch.full((blocks * 256,), noise.shape[0]) if budgets is None else
                   torch.minimum(budgets.repeat_interleave(budget_block)[:blocks * 256],
                                 torch.tensor(noise.shape[0])))
    for s in range(noise.shape[0]):
        st = trace.trace_sample(scene, settings, cols, rows, noise=noise[s], width=W, height=H,
                                max_path_length=MAXLEN)
        u, v = equirect_from_dir(st.esc_dir, settings.azimuth)
        pad = blocks * 256 - p
        u, v = (torch.nn.functional.pad(x, (0, pad)) for x in (u, v))
        esc_w = torch.nn.functional.pad(st.esc_w.stack(), (0, pad))
        direct = torch.nn.functional.pad(st.radiance.stack(), (0, pad))
        env = torch.zeros(3, blocks * 256)
        for t0 in range(0, blocks * 256, 128):
            tile = slice(t0, t0 + 128)
            if t0 >= p or (env_skip and not esc_w[:, tile].any()):
                continue
            out = _chain_from_slices(model, u[tile], v[tile])  # (128, 3) network order
            env[:, tile] = esc_w[:, tile] * out.flip(1).t()
        on = s < lane_budget
        rad += torch.where(on, direct + env, torch.zeros(()))
        plen += torch.where(on, torch.nn.functional.pad(st.path_len, (0, pad)), 0)
    return rad[:, :p], plen[:p]


@pytest.mark.parametrize("asset", BF16_ASSETS)
def test_k3_tiles_match_the_reference(asset):
    """The kernel's tiles and operands, with the env-skip on, compute the
    reference composition (JAX) within tests/test_megastep.py's budget,
    on 576 rays: three CUDA blocks, the last with one live tile."""
    scene, cfg, settings, _, cols, rows, noise = _setup()
    params = jnif.load_nif_assets(str(ASSETS / asset), jnp.bfloat16)[0]
    ref_rad, ref_plen = _xla_twin(scene, cfg, settings, params, cols, rows, noise)
    model = nif.params_from_jax(params)
    rad, plen = _k3_tiles(model, default_scene(), RenderSettings.make(samples_per_step=SAMPLES),
                          torch.from_numpy(np.array(cols)), torch.from_numpy(np.array(rows)),
                          torch.from_numpy(noise), env_skip=True)
    assert_matches_twin(rad.numpy(), plen.numpy(), ref_rad, ref_plen)


@pytest.mark.parametrize("scene_name", ["default", "enclosed"])
def test_k3_tiles_skip_and_budgets_exact(scene_name):
    """Budgets of 0, 1 and 3 in one launch, at a ragged 576 rays: the
    env-skip on equals off bit for bit (a skipped tile adds exact zeros),
    budget 0 leaves zeros, and the result is the plain megastep's
    (ops/megastep.render_megastep_plain, itself held to the JAX package)
    within the bf16 budget, the path lengths exactly."""
    _, _, _, params, cols, rows, noise = _setup()
    model = nif.params_from_jax(params)
    scene = SCENES[scene_name]()
    settings = RenderSettings.make(samples_per_step=SAMPLES)
    cols, rows = torch.from_numpy(np.array(cols)), torch.from_numpy(np.array(rows))
    noise = torch.from_numpy(noise)
    budgets = torch.tensor([0, 1, 3], dtype=torch.int32)
    on = _k3_tiles(model, scene, settings, cols, rows, noise, budgets, env_skip=True)
    off = _k3_tiles(model, scene, settings, cols, rows, noise, budgets, env_skip=False)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    assert not on[0][:, :256].any() and not on[1][:256].any()
    ref = megastep.render_megastep_plain(scene, settings, model, cols, rows, noise=noise,
                                         width=W, height=H, max_path_length=MAXLEN,
                                         budgets=budgets, budget_block=256)
    assert torch.equal(on[1].to(torch.int32), ref.path_len)
    got, want = on[0], ref.radiance.stack()
    rel = (got - want).abs() / (want.abs() + 1e-2 * want.abs().max())
    assert float(rel.median()) < 5e-3 and float(rel.max()) < 8e-2
    if scene_name == "enclosed":
        assert torch.equal(got, want)  # nothing escapes: the trace alone, bit for bit
