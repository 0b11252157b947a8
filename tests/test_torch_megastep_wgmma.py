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
    block's 256 rays two 128-ray wgmma tiles;
  * the chain selector: a bf16 model's NifWg and an int8 model's NifWg,
    each with K3's plan; any other struct is refused;
  * the chain's tile (the queue's tile): 128 rays for both chains;
  * the kernel's arithmetic from its operands - per 256-ray block its
    budget of samples, per sample the trace, the escapes of the block's
    samples queued and shaded 128 at a time through the chain of the
    swizzled slices (test_torch_nif_wgmma), the last tile partial -
    against the reference composition (tests/test_megastep.py::_xla_twin)
    with that test's tolerance, equal bit for bit to shading sample by
    sample with the reference's dead-tile skip, in ceil(escapes / 128)
    tiles a block, and none on the enclosed scene.
"""

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

ASSETS = Path(__file__).resolve().parent.parent / "assets"
# Every NIF asset in assets/ but the int8 one (its quant_amax.json).
BF16_ASSETS = sorted(p.name for p in ASSETS.iterdir()
                     if (p / "converted.hdf5").exists() and not (p / "quant_amax.json").exists())
CANONICAL = "urban_alley_synth_nif"
SCENES = {"default": default_scene, "enclosed": lambda: scene_from_dict(ENCLOSED),
          **{p.stem: (lambda p=p: load_scene(str(p)))
             for p in sorted((ASSETS / "scenes").glob("*.json"))}}
LIMIT = 232_448  # shared memory a block may use (csrc/nif_wgmma.cuh kWgSmemLimit)
# csrc/megastep.cuh: the escape queue's 384 entries ((u, v), escape weights and
# direct luminance as f32, a one-byte owner), the eight warps' counts, the
# control word.
TAIL = 384 * (2 + 3 + 1) * 4 + 384 + 8 * 4 + 16


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
    """The plan csrc/megastep.cuh's comment states: 3 stages, 232,224 B."""
    plan = megastep.megastep_wg_plan(_load(CANONICAL), default_scene())
    assert megastep.table_bytes(default_scene()) == 300
    assert (plan["stages"], plan["smem_uv"], plan["smem_tables"], plan["smem_bytes"]) == (
        3, 221_248, 230_896, 232_224)


@pytest.mark.parametrize("count, stages", [(1, 3), (11, 3), (12, 2), (864, 2), (865, None),
                                           (1000, None)])
def test_stages_follow_the_tables(count, stages):
    """Stages by formula: 3 while the tables take at most 528 B (11
    spheres, 528 B), 2 up to 41,488 B (864 spheres, 41,472 B), and past
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
    assert megastep.QUEUE_ENTRIES % nif_ops.WG_RAYS == 0  # the queue's slots are whole tiles


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
    """K3 takes an f32 model on the tf32 chain (its plan names the chain
    where it does not fit) and refuses weights of any other type."""
    model = nif.load_nif_assets(str(ASSETS / CANONICAL), torch.float32)[0]
    net = megastep.kernel_net(model, default_scene())
    assert (net.tf32, net.int8, net.smem_bytes) == (1, 0, 232_224)
    with pytest.raises(ValueError, match="bf16, f32 or int8"):
        megastep.kernel_net(nif.load_nif_assets(str(ASSETS / CANONICAL), torch.float16)[0],
                            default_scene())
    big = scene_from_dict({"objects": [
        {"type": "sphere", "center": [float(i), 0.0, -5.0], "radius": 0.4,
         "colour": [0.5, 0.5, 0.5], "material": "diffuse"} for i in range(1000)]})
    with pytest.raises(ValueError, match="tf32 chain"):
        megastep.kernel_net(model, big)


@pytest.mark.parametrize("asset", BF16_ASSETS)
def test_env_skip_tile_by_chain(asset):
    """Both chains run K3's 128-ray wgmma tiles, so the chain's tile (the
    escape queue's tile, which the K3 record counts in) is 128 for
    either."""
    model = _load(asset)
    _, meta, weights = nif.load_nif_assets(str(ASSETS / asset))
    for m in (model, quantize_nif(weights, meta)):
        assert megastep.chain_tile(m) == nif_ops.WG_RAYS == 128
        assert megastep.kernel_net(m, default_scene()).num_layers == m.num_layers


def _k3_tiles(model, scene, settings, cols, rows, noise, budgets=None, budget_block=256,
              queue=True):
    """The bf16 K3's arithmetic on the CPU, from its operands: per 256-ray
    block its budget of samples (all S without budgets), per sample the
    plain trace on the host noise.  With ``queue`` (the kernel): the
    block's escapes (escape weights not all zero) queued over its samples
    in sample and lane order and shaded 128 at a time through the chain of
    the swizzled slices, the last partial tile after the last sample, its
    rows past the queue at (u, v) = 0; without (the kernel before the
    queue): each sample's two 128-ray tiles, a tile
    skipped where none of its rays is live or escapes (the reference's
    dead-tile skip).  Each sample's
    radiance, direct + the bgr -> rgb env term times the escape weights,
    summed in sample order (the kernel adds a sample's direct and env
    terms apart, in another order).  (3, P), (P,) and the tiles each
    block ran."""
    p = cols.shape[0]
    blocks = -(-p // 256)
    pad = blocks * 256 - p
    block_budget = (torch.full((blocks,), noise.shape[0]) if budgets is None else
                    torch.minimum(budgets.repeat_interleave(budget_block // 256)[:blocks],
                                  torch.tensor(noise.shape[0])))
    u, v, esc_w, direct, plen = [], [], [], [], []
    for s in range(noise.shape[0]):
        st = trace.trace_sample(scene, settings, cols, rows, noise=noise[s], width=W, height=H,
                                max_path_length=MAXLEN)
        su, sv = equirect_from_dir(st.esc_dir, settings.azimuth)
        u.append(torch.nn.functional.pad(su, (0, pad)))
        v.append(torch.nn.functional.pad(sv, (0, pad)))
        esc_w.append(torch.nn.functional.pad(st.esc_w.stack(), (0, pad)))
        direct.append(torch.nn.functional.pad(st.radiance.stack(), (0, pad)))
        plen.append(torch.nn.functional.pad(st.path_len, (0, pad)))
    u, v, esc_w, direct, plen = (torch.stack(x) for x in (u, v, esc_w, direct, plen))
    escapes = esc_w.abs().sum(dim=1) != 0  # (S, lanes)
    env = torch.zeros_like(direct)
    tiles = torch.zeros(blocks, dtype=torch.int64)

    def shade(s_idx, lane):  # one tile of (sample, lane) rows
        uu, vv = torch.zeros(128), torch.zeros(128)
        uu[:len(lane)], vv[:len(lane)] = u[s_idx, lane], v[s_idx, lane]
        out = _chain_from_slices(model, uu, vv)[:len(lane)]  # network order
        env[s_idx, :, lane] = esc_w[s_idx, :, lane] * out.flip(1)

    for b in range(blocks):
        budget = int(block_budget[b])
        if queue:
            s_idx, lane = escapes[:budget, 256 * b:256 * (b + 1)].nonzero(as_tuple=True)
            for t0 in range(0, len(lane), 128):
                shade(s_idx[t0:t0 + 128], 256 * b + lane[t0:t0 + 128])
                tiles[b] += 1
            continue
        for s in range(budget):
            for t0 in range(256 * b, 256 * (b + 1), 128):
                if t0 < p and escapes[s, t0:t0 + 128].any():
                    shade(torch.full((128,), s), torch.arange(t0, t0 + 128))
                    tiles[b] += 1
    on = (torch.arange(noise.shape[0])[:, None] < block_budget.repeat_interleave(256)[None])
    rad = torch.zeros(3, blocks * 256)
    for s in range(noise.shape[0]):
        rad += torch.where(on[s], direct[s] + env[s], torch.zeros(()))
    plen = torch.where(on, plen, 0).sum(dim=0)
    return rad[:, :p], plen[:p], tiles


@pytest.mark.parametrize("asset", BF16_ASSETS)
def test_k3_tiles_match_the_reference(asset):
    """The kernel's queue, tiles and operands compute the reference
    composition (JAX) within tests/test_megastep.py's budget, on 576 rays:
    three CUDA blocks, the last with 64 live rays."""
    scene, cfg, settings, _, cols, rows, noise = _setup()
    params = jnif.load_nif_assets(str(ASSETS / asset), jnp.bfloat16)[0]
    ref_rad, ref_plen = _xla_twin(scene, cfg, settings, params, cols, rows, noise)
    model = nif.params_from_jax(params)
    rad, plen, _ = _k3_tiles(model, default_scene(), RenderSettings.make(samples_per_step=SAMPLES),
                             torch.from_numpy(np.array(cols)), torch.from_numpy(np.array(rows)),
                             torch.from_numpy(noise))
    assert_matches_twin(rad.numpy(), plen.numpy(), ref_rad, ref_plen)


@pytest.mark.parametrize("scene_name", ["default", "enclosed"])
def test_k3_tiles_skip_and_budgets_exact(scene_name):
    """Budgets of 0, 1 and 3 in one launch, at a ragged 576 rays: the queue
    equals shading sample by sample with the dead-tile skip bit for bit (each
    sample's terms are the same rows of the same chain, summed in sample
    order), runs ceil(escapes / 128) tiles a block and fewer than before,
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
    on = _k3_tiles(model, scene, settings, cols, rows, noise, budgets)
    off = _k3_tiles(model, scene, settings, cols, rows, noise, budgets, queue=False)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    assert not on[0][:, :256].any() and not on[1][:256].any()
    ref = megastep.render_megastep_plain(scene, settings, model, cols, rows, noise=noise,
                                         width=W, height=H, max_path_length=MAXLEN,
                                         budgets=budgets, budget_block=256)
    assert torch.equal(on[1].to(torch.int32), ref.path_len)
    got, want = on[0], ref.radiance.stack()
    rel = (got - want).abs() / (want.abs() + 1e-2 * want.abs().max())
    assert float(rel.median()) < 5e-3 and float(rel.max()) < 8e-2
    escapes = torch.zeros(3, dtype=torch.int64)
    for s in range(SAMPLES):
        st = trace.trace_sample(scene, settings, cols, rows, noise=noise[s], width=W, height=H,
                                max_path_length=MAXLEN)
        esc = torch.nn.functional.pad(st.esc_w.stack().abs().sum(dim=0) != 0, (0, 3 * 256 - 576))
        escapes += esc.reshape(3, 256).sum(dim=1) * (s < budgets)
    assert torch.equal(on[2], -(-escapes // 128)) and bool((on[2] <= off[2]).all())
    if scene_name == "enclosed":
        assert torch.equal(got, want)  # nothing escapes: the trace alone, bit for bit
        assert not on[2].any()


@pytest.mark.parametrize("budgeted", [False, True], ids=["uniform", "budgets"])
def test_k3_tiles_enclosed_shades_no_tile(budgeted):
    """On the enclosed scene no ray escapes, so the queue holds nothing and
    no block shades a tile, with budgets (0, 1 and 3) and without; the
    result is the trace's alone, the plain megastep's bit for bit."""
    _, _, _, params, cols, rows, noise = _setup()
    model = nif.params_from_jax(params)
    scene = SCENES["enclosed"]()
    settings = RenderSettings.make(samples_per_step=SAMPLES)
    cols, rows = torch.from_numpy(np.array(cols)), torch.from_numpy(np.array(rows))
    noise = torch.from_numpy(noise)
    kw = dict(budgets=torch.tensor([0, 1, 3], dtype=torch.int32), budget_block=256) \
        if budgeted else {}
    rad, plen, tiles = _k3_tiles(model, scene, settings, cols, rows, noise, **kw)
    assert tiles.shape == (3,) and not tiles.any()
    ref = megastep.render_megastep_plain(scene, settings, model, cols, rows, noise=noise,
                                         width=W, height=H, max_path_length=MAXLEN, **kw)
    assert torch.equal(rad, ref.radiance.stack()) and torch.equal(plen.to(torch.int32),
                                                                   ref.path_len)
    assert float(rad.max()) > 0
