"""GPU smoke check of the PyTorch/CUDA port: build, check, run, time.

    python3 chip_smoke.py          # from the root of a checkout, one CUDA GPU

Phases, one line each:
  1. device   - needs CUDA; prints nvidia-smi's name and power limit;
  2. build    - compiles the kernels from csrc/ (nvcc, sm_90a) and loads them;
  3. K1       - trace kernel vs its plain version, host noise and Philox,
                256x256, L=10;
  4. K2       - env-shade kernel vs its plain version on the canonical NIF
                and on the mixed-width one, 65,536 numpy-seeded escapes, and
                with the int8 chain on assets/urban_alley_synth_nif_int8 and
                the mixed-width PTQ (bit for bit); both chains
                (csrc/nif_wgmma.cuh, 128-ray tiles) again on 65,536 + 37
                escapes, a ragged last tile;
  4b. K4      - NIF-apply kernel vs its plain version on 65,536 numpy-seeded
                (u, v): bf16 on the canonical and mixed-width assets, int8 on
                both (lattice-calibrated) and on the int8 asset (its QAT grids),
                bit for bit; both chains again at 65,536 + 37 points;
  4c. SASS    - the env-shade and NIF-apply kernels hold their wgmma in the
                built library (cuobjdump; the phase fails without it): bf16
                HGMMA and no HMMA (mma.sync), int8 IGMMA (wgmma s8) and no
                IMMA, HMMA or HGMMA with a register operand (ptxas may add a
                dummy HGMMA on RZ, which computes nothing); likewise K3
                (megastep_wg_kernel, both chains): every instantiation with
                a chain (Philox, host noise, Sobol, each untraced and
                recording the per-block record, the 'trace' stubs) holds
                its chain's wgmma and no mma.sync, the 'nif' and 'both' stubs
                no MMA at all, and no megastep_kernel (the old mma.sync K3) is
                built; ptxas reports no spills for any K2, K3 or K4 kernel
                (their lines printed);
  4d. tf32    - the f32 chain (--partials-type float) on TF32 wgmma, 3xTF32
                (probes/tf32_chain.py): K2 on a 1104x1000 sample's escapes
                and 65,573 numpy-seeded ones, K4 on the 1104x1000 lattice,
                a bake chunk and 65,573 points, K3 at 1104x1000 (8 samples)
                and at a ragged 65,317 lanes with budgets 0/1/8 and the
                statistics, each against its plain f32
                version (TF32 off) by the reference's f32 rule (max of
                |out - ref| / (|ref| + 1e-2 max|ref|) < 1.5e-2; K3 also
                < 5e-3 flipped lanes), its median and max printed beside the
                bf16 kernel's against the same plain f32 chain, and smaller
                in both; the SASS phase (4c) holds every tf32
                instantiation (K2, K4, K3's) to HGMMA on tf32 only;
  5. K3       - megastep kernel vs its plain version, host noise, 256x256,
                4 samples, bf16 and int8 (path lengths bit for bit, int8
                radiance within SUM_ORDER_REL);
  5b. modes   - K1 in Owen-Sobol mode (12 and 4 + 4L dims, bit for bit) and
                K3, bf16 and int8, in Sobol mode, with per-block budgets and
                the statistics (hardware and host noise), and with all of
                them at once, vs their plain versions at 256x256; and K3 on
                the enclosed scene (nothing escapes, so no tile is shaded)
                against its plain version; then K3, bf16 and int8, at a
                ragged 65,317 lanes (the last CUDA block has one live
                128-ray tile) with budgets of 0, 1 and 8 in one launch and
                the statistics, Philox and host noise, and on the enclosed
                scene;
  5c. stubs   - K3's measurement stubs 'nif', 'trace' and 'both', bf16 and
                int8, Philox and Sobol, vs their plain versions at 256x256:
                'trace'/'both' exactly (radiance 0, path lengths S x L),
                'nif' with the path lengths bit for bit and the radiance
                within 1e-6 relative (the env term is the decode of ones,
                expf against torch.exp); again at 1104x1000 in phase 7;
  6. main     - the CLI (runtime/cli.main) at 1104x1000, 16 spp in steps of
                8: assets/urban_alley_synth_nif fused and unfused; the int8
                asset with --nif-precision int8 fused and unfused;
                --nif-mode baked (bf16, then int8); --device-film (saving
                every step, then only at the last); --device-film --adaptive;
                --sampler sobol fused and unfused; --scene <enclosed>; and
                the int8 asset
                with --device-film --adaptive --sampler sobol; and
                --enable-load-balancing (the reference's shuffle and
                per-step re-deal) fused; --partials-type float fused,
                unfused and --nif-mode baked (the tf32 K3, K2 and K4).  Every
                kernel's launch counter is set to 0 just before each run and
                read just after (a fused run launches K3 alone), and so is
                each call counter of the native host
                runtime and of its plain versions; the app's log (each
                step's, save's, wait's and bake's seconds) goes to stdout.
                The device-film frames must equal
                the host film's, and fused and unfused frames, and the load
                balancer's and the main fused one, agree in mean
                luminance within 5 standard errors;
  6a. host    - the host pipeline: a serial loop (render_step, the fetch and
                the plain film, step after step) writes the main fused
                run's EXR byte for byte; a timer thread sends SIGTERM once
                step 1 of 2 is logged and the CLI exits 0 with the image and
                the checkpoint of step 1 on disk; --resume from it writes the
                uninterrupted run's EXR byte for byte (K3 launched once in
                each half), for the host film and --device-film --adaptive;
  6b. timing  - one more CLI run at 1104x1000 with --device-timing
                --profile-dir --metrics-file: the env / trace / overhead split
                as the app logs it (positive, summing to the step to the
                log's 1e-3 ms), one metrics line per step
                plus the summary, the app's spans in trace.json, the device
                kernel events found there by name and the device's busy
                share of the render window; after phase 7 the split's step
                must be within 10% of K3's own time per sample;
  6b'. f32 timing - --device-timing with --partials-type float: the split
                and the stubs' launches on the f32 chain;
  6c. canonical - one CLI run at 1104x1000, 1200 spp in four steps of 300
                saving every step, with --profile-dir and --metrics-file:
                wall, loop, step, save and wait-for-host seconds and the
                device's busy share (the host task's spans are in the trace);
                then every CLI run of phases 6-6c must have taken the native
                host runtime (its film, tone map and clear; the re-deal with
                --enable-load-balancing only) and no plain version;
  6e. flags   - --compile-only prints the built library and renders nothing;
                --compile-only --save-exe writes the library and its manifest
                (digest, nvcc flags, GPU), and a fresh process with
                --load-exe renders the main fused run's EXR byte for byte;
                the turntable (tools/turntable.py) at 1104x1000, 8 spp, 4
                frames: 4 distinct JPEG samples, K3 launched once a frame,
                its seconds per frame;
  6d. ui      - the interactive path: the CLI with --ui-port (a free port)
                --denoise at 1104x1000, 8 spp a step, driven by the port's
                client in this process, four times (host film and
                --device-film, each in bf16 and with --nif-precision int8):
                >= 3 previews, an exposure change (the progress keeps
                rising: no restart), a fov change, a load_nif of
                assets/urban_alley_synth_nif_int8 (the int8 runs launch K3
                on its QAT grids after it) and interactive_samples 16 (each
                restarts: the progress returns to step 1), stop, exit 0;
                each run's launches (K3, K4 for the guides, no K1), native
                film, tone map and JPEG calls
                and no plain call; the codec make_encoder picks; then the
                guides' sky albedo from K4 against the plain version (the
                bf16 tail rule), the on-card denoised preview against
                denoise_hdr and the native tone map of the fetched film
                (<= 1 code value), the device preview, denoised preview,
                denoise, cold guides and native JPEG times, and a --denoise
                save and every --debug-view mode through the CLI at
                1104x1000 (the debug EXRs equal debug_view of the guides);
                the UI's step seconds beside the headless main run's;
  6f. train   - the NIF tools: (a) the trainer's CLI (models/train_nif.py)
                on the card with the canonical recipe's shapes (6x320,
                batch 65,536, the 2048x4096 synth, cosine) for 300 epochs
                (600 steps): the median ms per step beside its bound, the
                loss down TRAIN_LOSS_DROP-fold, TF32 off in every step and
                the flag restored after; (b) the first 3 steps on the card
                against the same steps on the CPU (same initial params and
                batches, TRAIN_* below); (c) the written asset reloaded
                (hidden size 320), the quality gate on it through K4 against
                its plain version (PSNR_GAP_DB), a fused 1104x1000 8-spp
                render with --assets on it (K3; finite pixels); (d) 50
                epochs of QAT (models/quant.qat_finetune) from the shipped
                bf16 asset, K4 (bit for bit) and K3 int8 (as phase 5) on the
                result against their plain versions, the asset written and its int8 load
                through runtime/app.parse_env_assets equal to quantize_nif of
                the stored weights with the fine-tune's grids;
  7. full frame - at the main path's shapes (1104x1000, a ragged last
                block): K1 (Philox), K2 (on that sample's escapes, bf16 and
                int8), K3 (Philox, 8 samples, bf16 and int8), K4 (one bake
                chunk of 10 rows of 4096, bf16 and int8) and phase 5b's
                modes vs their plain versions, K1 bit for bit in Philox,
                Sobol and host-noise mode at 1104x1000 and at a ragged
                65,317 lanes, then each kernel and its plain version timed
                (CUDA events, after warm-up; K1 also alone, one prepared
                launch back to back, beside its wrapper), K3 on the enclosed
                scene beside the open one (no escape, so no chain: under a
                quarter of its time, bf16 and int8), and the adaptive step against the uniform one; K3's stubs vs their
                plain versions (as phase 5c), then timed beside them (the
                'trace' stub less the skeleton is the chain alone, a
                cross-check of the split's env); repeated K1 launches (three
                modes) and K3 launches (bf16 Philox, host noise; int8 Sobol with budgets and statistics) under
                torch.cuda.set_sync_debug_mode("error"), which must raise
                for no launch (and must raise for the control, the fov
                computed anew); --device-timing's unfused
                split (K1 and
                K2 standalone); the seven-product cuBLAS bf16 chain at the
                NIF kernels' shapes (a yardstick the port never calls), and
                K4 bf16 and that chain at the quality gate's 524,288-point
                batch; and the int8 analog, a torch._int_mm chain with K5's
                epilogue, and its products alone, at the full frame and the
                bake chunk (yardsticks the port never calls);
  8. probes   - K6/K7 (probes/overlap.py): every variant vs its plain
                version at the scripts' 1,105,920 lanes (K6 'mxu' and 'both'
                and K7's four loops on the bf16 wgmma tile), then the
                probe's entry point (its lines: ms per call or loop
                iteration, the serial and the overlap prediction) with its
                launch counters zeroed before and read after, the plain
                versions and the library chains timed (the cuBLAS bf16
                chain of the probe's layers, plus the eager ALU rounds for
                'both' and the loops; yardsticks the port never calls), and
                each K7 variant must beat its library chain;
  9. K8       - the precision probe (probes/quant.py): each of its six
                variants, all on the wgmma tiles (fp8 exact on bf16: the
                e4m3 codes' bf16 values, HGMMA with f32 sums), vs its
                plain version at the script's 1,105,920 rays (int8 bit for
                bit; bf16 within K8's own budget below, its kernel launched
                K8_BF16_LAUNCHES times and every launch equal; fp8 within
                the budget below),
                then the probe's entry point with its launch counters
                zeroed before and read after, the plain versions and the
                library chains timed (one cuBLAS product per layer: bf16
                matmul, torch._int_mm, torch._scaled_mm; yardsticks the port
                never calls), the MMA instructions of each variant's
                compiled kernel counted (cuobjdump: HGMMA and no HMMA in
                bf16 and fp8, IGMMA and no IMMA or HMMA in the int8
                variants, and none holds QGMMA or QMMA; likewise HGMMA and
                no HMMA in K6 'mxu' and 'both' and K7's four loops; no
                mma.sync kernel of K6, K7 or K8 built; no spills; no kernel
                of the library holds HMMA, IMMA or QMMA); then the on-class
                quality gate
                (probes/quant_psnr.py: the 2048x4096 synthetic frame through
                K4, bf16, int8 PTQ and the asset in f32 on the tf32 chain)
                with K4's launches counted against the
                batches, and again with the plain versions on the card: each
                PSNR within 0.05 dB of the plain version's.  Then K2 bf16 and
                K3 bf16 per 1104x1000 sample (wgmma) must each beat the
                cuBLAS chain of the same run at 1,104,000 rays, printed
                beside the unfused step (K1 + K2) and the device timing
                split; K6 'mxu' must beat the cuBLAS chain of its layers over
                its 1,105,920 lanes, K8 fp8_e4m3 and fp8_raw the
                torch._scaled_mm chain; and K3 int8 must beat the
                torch._int_mm chain's products alone (and so the whole
                chain).
  11. mesh    - the device mesh (parallel/mesh.py, probes/validate_mesh.py) on
                one card, after phase 10: the 1x1 mesh bit for bit against the
                mesh-less render with the folded seed at 1104x1000 @ 8 spp
                (bf16 and int8; Philox, Sobol, two adaptive steps with lum2);
                the virtual 8x1, 4x2 and 2x4 meshes on cuda:0 against their
                single-device replay (K3, and K1 + K2; 8x1 bit for bit, the
                others within rtol 1e-6, atol 1e-7), each with one sharded step
                under torch.cuda.set_sync_debug_mode("error"); the K3 step per
                sample of the mesh-less render, the 1x1 and the virtual meshes,
                timed; the CLI with --mesh-shape 1x1 (host film, device film,
                unfused, baked, --device-timing), the launch counters zeroed
                before each run and read after, each frame within 5 SE of its
                mesh-less run of phase 6 and the Samples/sec/chip line logged;
                --ipus one more than the GPUs exits non-zero naming both
                counts; with two GPUs or more the 2x1 and 1x2 meshes over two
                of them (NCCL) against the replay, else one line saying that
                it did not run (neither PASS nor FAIL); its seconds printed;
  12. studies - the port's studies (probes/ and tools/, each through its
                main, output under build/chip_smoke/studies): adaptive_bench,
                sobol_bench (its consistency check must pass), denoise_bench,
                adaptive_depth_check (with adaptive_bench's speedup) and
                adaptive_knob_sweep at 368x336 with ground truths of 1024
                spp and steps of 32, each with finite, well-formed fields;
                fused_bench, phase_bench, megastep_split (every chain and
                stub), host_roundtrip_bench, coherent_layout_probe,
                envskip_bench (the enclosed scene all dead, K3 timed) and
                scene_scale_bench (every count, bf16) at 1104x1000 with few
                repetitions; each count's grid_scene through K3 against its
                plain version (host noise, 16x16); the three figure tools,
                gen_sobol_dirs equal to render/_sobol_dirs.DIRS, and ui_probe
                (a CLI subprocess) through its five phases; the launch
                counters zeroed before each in-process study and read after
                (K3 launched, no plain version on the card); its seconds
                printed;
Then a JSON line with the kernels, the nvidia-smi line again, and the last
line {"ok": true, "device": {...}}.  Any failed check exits non-zero and
prints no result.  Tolerances are the reference's own:
  * tangent rays may flip between hit and miss under another compiler, so
    escaped/path_len must agree on >= 99.5% of lanes, and the other lanes'
    floats are held to the trace test's rtol 1e-4 / atol 3e-5
    (tests/test_trace_pallas.py, tests/test_megastep.py:79-90);
  * the bf16 NIF chain to median relative error 5e-3 and max 8e-2
    (tests/test_nif_pallas.py: bf16 features may round on opposite sides
    of an ulp and the log decode exponentiates the gap);
  * the int8 chain (K2, K3, K4 and K8's int8 variants) bit for bit: its
    integer sums are exact in any order and its f32 epilogue rounds where
    the plain version rounds (--fmad=false), on the same encode; K3 adds
    those bit-exact samples into each ray's sums in another order (its
    escape queue), so its radiance and sqrt(lum2) are held to
    SUM_ORDER_REL of the plain version's;
  * the overlap probes' chains (no log decode) to the bf16 budget, their
    ALU chain to rtol 1e-5 on all but 5e-3 of the lanes (the x > 1 select);
  * K8's bf16 chain (random He-scaled weights, no decode) within K8's own
    budget (K8_BF16_* below: the rounding tail of these outputs, measured
    on the wgmma tile, not K3's rule); K8's fp8 chains
    to median 1e-3, at most 1e-4 of the outputs above 1e-2 and max 2: the
    kernel's f32 sums and the plain version's round in another order, a
    requantised e4m3 code (3 mantissa bits) then moves by a step, and
    measured were median 0, 8.4e-6 of the outputs above 1e-2 and max 1.43
    (a near-zero output, the 1% floor) on mma.sync, and median 0, 1.7e-5
    and 1.43 on the wgmma tile; the fp8 tensor cores' own sums (QGMMA,
    and cuBLAS's fp8 chain: probes/fp8_qgmma.py) are far coarser and do not
    meet it (PERF.md), so the fp8 variants run exact on bf16;
  * the new modes of K1 and K3 bit for bit, except K3's radiance and lum2
    with the int8 chain (SUM_ORDER_REL, above) and its bf16 radiance and
    the square root of its lum2 (whose relative error is that of the
    samples' luminance): median 5e-3 and max 8e-2 on all but at most one
    lane in 10^4, and every lane below 0.25.  From 256x256 up, a lane of
    the bf16 chain passes 8e-2 about once in 10^5 in every RNG mode,
    Philox included: the error of one sample's env term sets its lane's
    (the trace parts agree bit for bit), and the worst lanes measured are
    0.124 (Sobol) and 0.125 (Philox), and 0.13 over the full bake lattice,
    so a max over a million lanes is a tail statistic.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from port_bench.counts import PEAK_BYTES, PEAK_OPS

ROOT = Path(__file__).resolve().parent
ASSET = "assets/urban_alley_synth_nif"
INT8_ASSET = "assets/urban_alley_synth_nif_int8"  # the canonical 6x320 after QAT
MIXED_ASSET = "assets/nif_m128-128-80-128-128-128"  # per-layer widths, skip at 80 + 48
MAIN_W, MAIN_H, MAIN_SPP, MAIN_SPS = 1104, 1000, 16, 8
UI_SPP = 100_000  # phase 6d: more steps than the client's session takes
CANON_SPP, CANON_SPS = 1200, 300  # the reference's canonical 300-spp step, four of them
FLIP_FRACTION = 5e-3
TRACE_RTOL, TRACE_ATOL = 1e-4, 3e-5
NIF_MEDIAN, NIF_MAX = 5e-3, 8e-2
# The bf16 chain's rounding tail: past 8e-2 on about one lane in 10^5, in
# every RNG mode (Philox included), at its worst 0.13 on one evaluation.
NIF_TAIL_FRACTION, NIF_TAIL_MAX = 1e-4, 0.25
# K3 adds each ray's samples in another order than its plain version: the
# escape queue adds a sample's direct radiance at once and its env term
# when its tile is shaded, perhaps after later samples'.  With the int8
# chain every direct and env term is the plain version's bit for bit, so
# the sums of S <= MAIN_SPS samples' nonnegative terms differ by at most
# (3S - 1) 2^-24 of themselves (2S terms in one order against S rounded
# pairs in another); 4S 2^-24 leaves room for the luminance's own sums.
SUM_ORDER_REL = MAIN_SPS * 2.0 ** -22
# K8's fp8 chains against their plain version (measured on the H100:
# median 0, 8.4e-6 (mma.sync) and 1.7e-5 (the bf16 wgmma tile) of the
# outputs above 1e-2, max 1.43; module docstring).
FP8_MEDIAN, FP8_ABOVE, FP8_FRACTION, FP8_MAX = 1e-3, 1e-2, 1e-4, 2.0
# K8's bf16 chain on the wgmma tile against its plain version, its own
# budget (not K3's NIF_TAIL_*): random He-scaled weights and no decode put
# many outputs near the 1% floor of the relative error, and the tile's f32
# sums, in another order than the plain version's, move a bf16 activation
# by an ulp now and then, which the next six layers carry on.  Measured on
# the H100 (bring-up, 1,048,576 rays): max 0.304, 6.4e-5 of the outputs
# past 8e-2; every launch gives the same outputs (K8_BF16_LAUNCHES).
K8_BF16_MEDIAN, K8_BF16_ABOVE, K8_BF16_FRACTION, K8_BF16_MAX = 5e-3, 8e-2, 2e-4, 0.6
K8_BF16_LAUNCHES = 10
K8_ITERS = 20  # timed launches per variant of probes.quant.main
PSNR_GAP_DB = 0.05  # the quality gate's kernel PSNR against the plain version's
# Phase 6f, the NIF tools: the canonical recipe's shapes (6x320, batch
# 65,536, 131,072 samples an epoch, the 2048x4096 synth, cosine) cut to
# TRAIN_EPOCHS; the loss must fall TRAIN_LOSS_DROP-fold from the first step.
TRAIN_EPOCHS, TRAIN_LOSS_DROP = 300, 10.0
# The card's first TRAIN_CPU_STEPS steps against the CPU's (same initial
# params, same batches drawn on the host): each loss to TRAIN_LOSS_RTOL
# relative (the products' sums round in another order); the parameters
# then differ by Adam's steps on gradients that the rounding moves, so in
# units of the learning rate: median TRAIN_PARAM_MEDIAN, at most
# TRAIN_PARAM_FRACTION of them past TRAIN_PARAM_ABOVE (a gradient near
# zero whose sign the rounding flips moves its parameter by up to two
# steps).  These two carry the check; the largest difference is printed
# but has no limit: over its first 3 steps Adam moves a parameter by at
# most ~1.004 lr a step (|m_hat| / sqrt(v_hat) <= sqrt(sum a_i^2 / b_i)),
# so any two 3-step runs differ by at most ~6 lr whatever they compute.
TRAIN_CPU_STEPS, TRAIN_LOSS_RTOL = 3, 1e-5
TRAIN_PARAM_MEDIAN, TRAIN_PARAM_ABOVE, TRAIN_PARAM_FRACTION = 1e-4, 1e-2, 1e-3
QAT_EPOCHS = 50  # phase 6f (d): QAT from the shipped bf16 asset, 100 steps
BAKE_ROWS = 30 * 1472 // 4096  # rows per bake chunk at the default --max-nif-batch-size
SOBOL_DIMS = 12  # the CLI's default --sobol-dims
SOBOL_KEY = 0x5EED5EED
ADAPTIVE_MIN = 2  # below --samples-per-step 8, so the controller's budgets vary
# K3 bf16's ragged check: 255 full CUDA blocks of 256 rays, then 37 rays (one
# live 128-ray tile, one dead).
RAGGED_K3 = 255 * 256 + 37
# The camera inside an emissive diffuse shell: no path escapes, so no block
# of K3 queues an escape or shades a tile (tests/test_megastep.py:129-135).
ENCLOSED_SCENE = {"objects": [
    {"type": "sphere", "center": [0.0, 0.0, 0.0], "radius": 50.0, "colour": [0.5, 0.5, 0.5],
     "material": "diffuse", "emission": [0.2, 0.2, 0.2]},
    {"type": "sphere", "center": [0.0, -0.5, -3.0], "radius": 0.5, "colour": [0.8, 0.3, 0.3],
     "material": "specular"},
]}

# The bound of a kernel is the larger of its bytes over the memory rate
# and its operations over the peak of their type: the H100 SXM's peaks of
# port_bench/counts.py (PEAK_BYTES, PEAK_OPS).
# The NIF chain's multiply-adds per ray: 48x320 + 2 x 320x320 + 368x320
# + 2 x 320x320 + 320x3 (the canonical 6x320 net, E = 12; the probes'
# LAYERS are the same products).
NIF_MACS = 543_680
# f32 operations of the trace, counted from csrc/common.cuh: per ray the
# camera ray (~40), per bounce each sphere test (~22), each disc test
# (~30) and the shading (~60).  The trace is bound by its bytes at these
# counts; they are estimates, not a tally of the compiled code.
TRACE_RAY_OPS, SPHERE_OPS, DISC_OPS, SHADE_OPS = 40, 22, 30, 60
# Estimated the same way: one Philox4x32-10 group (ten rounds of two
# 32-bit multiplies, xors and key bumps, then four u32 -> f32 conversions;
# integer operations counted at the f32 rate, which the H100's int32 rate
# does not exceed, so the bound stays a lower bound), and the NIF's input
# per ray (the equirect (u, v), then sin and cos of 12 frequencies of u and
# of v: 48 features).
PHILOX_GROUP_OPS, ENCODE_OPS = 110, 1000
ALU_ROUND_OPS = 8  # sin, x1.1, |x|, +0.3, sqrt, +, compare, select op

failures: list[str] = []


class LogLines(logging.Handler):
    """Keeps the app's log messages of the current CLI run."""

    def __init__(self):
        super().__init__()
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def phase_splits(self) -> list[dict]:
        """Each 'Device phase timing [<device>]: step=...' message of
        utils/devtime.log_phase_split as a dict of its numbers (ms)."""
        names = {"step": "step_ms", "trace": "trace_ms", "nif-env": "env_ms",
                 "other": "overhead_ms"}
        splits = []
        for ln in self.lines:
            if not ln.startswith("Device phase timing ["):
                continue
            device, rest = ln[len("Device phase timing ["):].split("]: ", 1)
            split = {"device": device, "mpaths_per_sec": float(rest.split("(", 1)[1].split()[0])}
            for tok in rest.split():
                if "=" in tok:
                    key, val = tok.split("=", 1)
                    split[names[key]] = float(val.split("ms", 1)[0])
            splits.append(split)
        return splits

    def seconds(self, prefix: str) -> list[float]:
        """The '... in <s> seconds' of each message that starts with prefix."""
        return [float(ln.split(" in ", 1)[1].split()[0]) for ln in self.lines
                if ln.startswith(prefix)]

    def waits(self) -> list[float]:
        """Each step's seconds waiting for the host task."""
        return [float(ln.split("wait for host ", 1)[1].split(";")[0]) for ln in self.lines
                if ln.startswith("Completed render step")]


class StopAfter(logging.Handler):
    """Once the app logs that step ``step`` completed, a timer thread sends
    this process SIGTERM, as a scheduler would; the handler waits for the
    timer, so the signal lands before the loop starts the next step."""

    def __init__(self, step: int):
        super().__init__()
        self.prefix = f"Completed render step {step}/"
        self.sent = False

    def emit(self, record):
        if not self.sent and record.getMessage().startswith(self.prefix):
            self.sent = True
            timer = threading.Timer(0.0, os.kill, (os.getpid(), signal.SIGTERM))
            timer.start()
            timer.join()


def host_entry_points() -> dict:
    """The host runtime's native entry points and their plain versions."""
    from ipu_path_trace_tpu_torch.film import film
    from ipu_path_trace_tpu_torch.runtime import native, worklist

    return {**{f.__name__: f for f in native.ENTRY_POINTS},
            **{f.__name__: f for f in (film.accumulate_plain, film.tone_map_plain,
                                       worklist.deal_order, worklist.clear_and_sum_plain)}}


def zero_host_calls() -> None:
    for f in host_entry_points().values():
        f.calls = 0


def host_calls() -> dict:
    return {k: f.calls for k, f in host_entry_points().items()}


def load_checkpoint_step(path: Path) -> int:
    with np.load(path) as z:
        return int(json.loads(z["meta"].tobytes())["step"])


def serial_loop(cfg) -> None:
    """The host film without the host task, as the loop was before it:
    render_step, the fetch and the plain film one step after another,
    then the save, on the app's worklist, settings and step seeds."""
    from ipu_path_trace_tpu_torch.core.records import from_device_batch, to_device_batch
    from ipu_path_trace_tpu_torch.film.film import Film
    from ipu_path_trace_tpu_torch.film.imageio import save_images
    from ipu_path_trace_tpu_torch.render.wavefront import render_step
    from ipu_path_trace_tpu_torch.runtime.app import PathTracerApp, step_seed

    app = PathTracerApp(cfg)
    app.init()
    app.build()
    settings, static = app.settings(), app.static_config()
    work = to_device_batch(app.worklist, app.device)
    gen = torch.Generator().manual_seed(cfg.seed)
    film = Film(cfg.width, cfg.height, native=False)
    steps = app.total_spp // cfg.samples_per_step
    for step in range(1, steps + 1):
        out = render_step(app.scene, settings, static, work, step_seed(gen), app.env,
                          sobol_base=(step - 1) * cfg.samples_per_step)
        film.accumulate(from_device_batch(out))
    save_images(cfg.outfile, film.hdr_at_step(steps), film.ldr(steps, cfg.exposure, cfg.gamma))


def phase(name: str, ok: bool, **info) -> None:
    fields = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{name}] {'PASS' if ok else 'FAIL'} {fields}", flush=True)
    if not ok:
        failures.append(name)


def nvidia_smi() -> str:
    """The card's name and power limit; every time printed here needs them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise SystemExit("chip_smoke: nvidia-smi not found; the card's name and power "
                         "limit go beside every number")
    res = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        raise SystemExit(f"chip_smoke: nvidia-smi failed (rc {res.returncode}): "
                         f"{res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def as_tensor(x) -> torch.Tensor:
    return x.stack() if hasattr(x, "stack") else x


def trace_exact(name, got, ref) -> float:
    """K1 against its plain version, every output bit for bit."""
    pairs = [(as_tensor(getattr(got, f)), as_tensor(getattr(ref, f))) for f in got._fields]
    err = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    phase(name, all(torch.equal(a, b) for a, b in pairs), max_abs_err=f"{err:.3e}")
    return err


def mode_check(name, got, ref, int8: bool) -> float:
    """K3 in a new mode against its plain version: path lengths bit for
    bit; radiance and sqrt(lum2) within the reordered sums' rounding
    (SUM_ORDER_REL) with the int8 chain, within the bf16 NIF budget, but
    for the chain's rounding tail, with the bf16 chain."""
    pairs = [(got.radiance.stack(), ref.radiance.stack())]
    stats_ok = (got.lum2 is None) == (ref.lum2 is None)
    if ref.lum2 is not None and got.lum2 is not None:
        pairs.append((got.lum2.sqrt()[None], ref.lum2.sqrt()[None]))
    err = max(float((a - b).abs().max()) for a, b in pairs)
    finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs)
    med = mx = tail = 0.0
    for a, b in pairs:
        rel = rel_err(a, b)
        med, mx = max(med, float(rel.median())), max(mx, float(rel.max()))
        tail = max(tail, float((rel > NIF_MAX).any(dim=0).float().mean()))
    close = (all(sum_order_close(a, b) for a, b in pairs) if int8
             else med < NIF_MEDIAN and tail <= NIF_TAIL_FRACTION and mx < NIF_TAIL_MAX)
    phase(name, stats_ok and finite and close and torch.equal(got.path_len, ref.path_len),
          path_len_equal=torch.equal(got.path_len, ref.path_len), median_rel=f"{med:.2e}",
          max_rel=f"{mx:.2e}", lanes_above_8e2=f"{tail:.2e}", max_abs_err=f"{err:.3e}",
          stats=ref.lum2 is not None)
    return err


def least_ms(nbytes: float, ops: dict[str, float]) -> tuple[float, str]:
    """The least time (ms) for moving nbytes and doing ops[type] of each
    type, and which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = sum(n / PEAK_OPS[k] for k, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_mm_chain(model, feats: torch.Tensor, epilogue: bool = True):
    """The int8 NIF's seven products as torch._int_mm (int8 -> int32) with
    K5's epilogue between them (models/quant.quant_layer_t: the f32
    multipliers, bias, ReLU and requant; the skip layer's two dots), over
    (P, 4E) int8 feature codes: the int8 analog of the cuBLAS chain
    (probes/tf32_chain.library_chain), a yardstick the port never calls.
    Written with few eager passes and the reference's f32 order (addcmul
    would fuse a product into the sum):
    every width padded to 16 once (zero weights, multipliers and biases)
    so no product is sliced, y = acc·m (+ accf·m_skip) + b, then the
    requant in place - clamp(y·inv, 0, 255) (ReLU included, inv > 0)
    rounded, cast to uint8 and flipped by 0x80 into the code q − 128.
    With ``epilogue=False`` only the products run, each on zero codes of
    its input width: the least any _int_mm chain can take.  Returns the
    chain as a function of no arguments."""
    skip, last = model.skip_layer, model.num_layers - 1
    feat = feats.shape[1]

    def pad(t, rows, cols):  # zeros past the fan-in and fan-out
        out = t.new_zeros((rows, cols))
        out[:t.shape[0], :t.shape[-1]] = t
        return out

    ws, k = [], feat
    for i, w in enumerate(model.kernels):
        n = -(-w.shape[1] // 16) * 16
        trunk, fw = (w[:-feat], w[-feat:]) if i == skip else (w, None)
        # column-major (K, N), cuBLASLt's int8 layout
        ws.append((pad(trunk, k, n).t().contiguous().t(),
                   None if fw is None else pad(fw, feat, n).t().contiguous().t(),
                   pad(model.biases[i][None], 1, n), pad(model.mults[i][None], 1, n)))
        k = n
    mult_skip = pad(model.mult_skip[None], 1, ws[skip][0].shape[1])
    inv = model.inv_next.tolist()
    zeros = {w.shape[0]: feats.new_zeros((feats.shape[0], w.shape[0])) for w, *_ in ws[1:]}

    def chain():
        x = feats
        for i, (w, wf, b, m) in enumerate(ws):
            if not epilogue:
                y = torch._int_mm(feats if i == 0 else zeros[w.shape[0]], w)
                if wf is not None:
                    torch._int_mm(feats, wf)
                continue
            y = torch.mul(torch._int_mm(x, w), m)
            if wf is not None:
                y.add_(torch.mul(torch._int_mm(feats, wf), mult_skip))
            y.add_(b)
            if i == last:
                return y
            codes = y.mul_(inv[i]).clamp_(0.0, 255.0).round_().to(torch.uint8).view(torch.int8)
            x = codes.bitwise_xor_(-128)
        return y

    return chain


def library_k8(ops):
    """K8's chain as library products, a yardstick the port never calls:
    per layer one cuBLAS product, ray-major - a bf16 matmul, torch._int_mm
    (int8 -> int32) or torch._scaled_mm (e4m3 -> bf16, unit scales; the
    head padded to 16 rows) - with the skip concat and one activation pass
    between products: relu (bf16), clamp to [0, 127] and the int8 cast
    (int8), relu and the e4m3 cast (fp8).  Returns the chain as a
    function of no arguments."""
    from ipu_path_trace_tpu_torch.probes.quant import SKIP

    kind = ("bf16" if ops.variant == "bf16" else "int8" if ops.variant.startswith("int8")
            else "fp8")
    u8, f8 = torch.uint8, torch.float8_e4m3fn
    if kind == "bf16":
        feats = ops.feats.t().to(torch.bfloat16).contiguous()
        ws = [w.t() for w in ops.weights]
    elif kind == "int8":
        feats = ops.feats.t().contiguous()
        ws = [w.t() for w in ops.weights]  # column-major (K, out), cuBLASLt's int8 layout
    else:
        feats = ops.feats.view(u8).t().contiguous().view(f8)
        ws = [torch.cat([w.view(u8), w.view(u8).new_zeros((-w.shape[0] % 16, w.shape[1]))])
              .view(f8).t() for w in ops.weights]
        one = torch.ones((), device=feats.device)
    last = len(ws) - 1

    def chain():
        x = feats
        for i, w in enumerate(ws):
            if i == SKIP:
                x = (torch.cat([x.view(u8), feats.view(u8)], 1).view(f8) if kind == "fp8"
                     else torch.cat([x, feats], 1))
            if kind == "bf16":
                y = x @ w
            elif kind == "int8":
                y = torch._int_mm(x, w)
            else:
                y = torch._scaled_mm(x, w, scale_a=one, scale_b=one, out_dtype=torch.bfloat16)
            if i < last:
                x = (torch.relu(y) if kind == "bf16" else y.clamp_(0, 127).to(torch.int8)
                     if kind == "int8" else torch.relu(y).to(f8))
        return y

    return chain


def sass_functions(lib_path: Path) -> list[tuple[str, str]] | None:
    """(mangled name, SASS) of each kernel in the built library; None
    without cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).exists():
        return None
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300).stdout
    return [(part.split(None, 1)[0], part) for part in sass.split("Function : ")[1:]]


MMA_OPS = ("HGMMA", "IGMMA", "QGMMA", "HMMA", "IMMA", "QMMA")


def mma_counts(part: str) -> dict:
    """The MMA instructions of one kernel's SASS: wgmma (HGMMA bf16 and
    tf32, IGMMA s8, QGMMA fp8) and mma.sync (HMMA, IMMA, QMMA).  ptxas may
    add a dummy HGMMA on RZ with no descriptor, which computes nothing (it
    closes a wgmma group): counted apart as HGMMA_RZ, not as HGMMA.  The
    HGMMAs on tf32 operands are also counted as HGMMA_TF32."""
    counts = {op: part.count(f" {op}.") for op in MMA_OPS}
    counts["HGMMA_RZ"] = len(re.findall(r" HGMMA\.\S+ RZ, gdesc\[URZ\], RZ", part))
    counts["HGMMA"] -= counts["HGMMA_RZ"]
    counts["HGMMA_TF32"] = len(re.findall(r" HGMMA\.\S+\.TF32 ", part))
    return counts


def sass_mma_counts(lib_path: Path) -> dict:
    """The MMA instructions of each K8 kernel in the built library's SASS,
    by variant; empty without cuobjdump."""
    counts = {}
    for name, part in sass_functions(lib_path) or []:
        m = WG_KERNELS["K8"].search(name)
        if m:
            counts[K8_NAMES[int(m[1])]] = mma_counts(part)
    return counts


# The wgmma kernels by their mangled template arguments: K2 and K4
# (<kOp>: operand bytes 1 int8, 2 bf16, 4 tf32), K3
# megastep_wg_kernel<kRng, kStub, kOp, kRecord>, K6's
# probe_wg_kernel<kAlu>, K7's probe_wg_loop_kernel<kPrng, kState>, K8's
# quant_probe_wg_kernel<variant>; and the old mma.sync kernels - K3's
# megastep_kernel, K6's probe_mxu_kernel and probe_both_kernel, K7's
# probe_loop_kernel, K8's quant_probe_kernel - which must no longer be built.
WG_KERNELS = {"K2": re.compile(r"16env_shade_kernelILi([124])E"),
              "K4": re.compile(r"16nif_apply_kernelILi([124])E"),
              "K3": re.compile(r"18megastep_wg_kernelILi(\d)ELi(\d)ELi([124])ELb([01])EE"),
              "K6": re.compile(r"15probe_wg_kernelILb([01])EE"),
              "K7": re.compile(r"20probe_wg_loop_kernelILb([01])ELb([01])EE"),
              "K8": re.compile(r"21quant_probe_wg_kernelILi(\d)EE")}
OLD_K3 = re.compile(r"15megastep_kernelI")
OLD_MMA_SYNC = re.compile(r"16probe_mxu_kernel|17probe_both_kernel|17probe_loop_kernelI"
                          r"|18quant_probe_kernelI")
RNG_NAMES = {0: "philox", 1: "host-noise", 2: "sobol"}
STUB_NAMES = {0: "production", 1: "stub nif", 2: "stub trace", 3: "stub both"}
K8_NAMES = {0: "bf16", 1: "int8_requant", 2: "int8_perchan", 3: "int8_raw", 4: "fp8_e4m3",
            5: "fp8_raw"}
K6_NAMES = {0: "mxu", 1: "both"}
K7_NAMES = {(0, 0): "loop", (1, 0): "loop+prng", (0, 1): "loop+state", (1, 1): "loop+both"}
OWN_MMA = {"bf16": "HGMMA", "int8": "IGMMA", "tf32": "HGMMA"}  # each chain's wgmma
CHAIN_OF_OP = {"1": "int8", "2": "bf16", "4": "tf32"}  # K2, K3, K4's <kOp>


def ptxas_lines(build_log: list[str], mangled: str) -> list[str]:
    """The ptxas lines (registers, stack, spills) of one kernel."""
    for i, ln in enumerate(build_log):
        if "Compiling entry" in ln and f"'{mangled}'" in ln:
            return [x.strip() for x in build_log[i + 1:i + 4]
                    if "registers" in x or "spill" in x or "stack" in x]
    return []


def wg_instantiations(functions, build_log: list[str]) -> dict:
    """Per wgmma kernel ("K2 int8", "K3 bf16 sobol stub trace", "K6 both",
    "K8 fp8_raw", ...): its chain, whether it should hold MMAs (the 'nif'
    and 'both' stubs run none), its MMA counts in the SASS and its ptxas
    lines with the spill bytes parsed."""
    out = {}
    for name, part in functions or []:
        for kernel, pat in WG_KERNELS.items():
            m = pat.search(name)
            if not m:
                continue
            if kernel == "K3":
                chain = CHAIN_OF_OP[m[3]]
                key = (f"K3 {chain} {RNG_NAMES[int(m[1])]} {STUB_NAMES[int(m[2])]}"
                       + (" recording" if m[4] == "1" else ""))
                mma = int(m[2]) in (0, 2)
            elif kernel == "K8":  # fp8 runs the bf16 tile
                v = int(m[1])
                chain = "int8" if 0 < v < 4 else "bf16"
                key, mma = f"K8 {K8_NAMES[v]}", True
            elif kernel == "K6":
                chain, key, mma = "bf16", f"K6 {K6_NAMES[int(m[1])]}", True
            elif kernel == "K7":
                chain, key, mma = "bf16", f"K7 {K7_NAMES[int(m[1]), int(m[2])]}", True
            else:
                chain = CHAIN_OF_OP[m[1]]
                key, mma = f"{kernel} {chain}", True
            lines = ptxas_lines(build_log, name)
            out[key] = {"mangled": name, "chain": chain, "mma": mma, **mma_counts(part),
                        "ptxas": lines,
                        "spill_bytes": sum(int(b) for x in lines
                                           for b in re.findall(r"(\d+) bytes spill", x))}
    return out


def holds_its_chain(v: dict) -> bool:
    """A wgmma kernel's SASS: its chain's wgmma and no other MMA where it
    runs the chain (bf16 HGMMA on bf16, tf32 HGMMA on tf32 and nothing
    else, int8 IGMMA), no MMA at all where it does not (the 'nif' and
    'both' stubs)."""
    own = OWN_MMA[v["chain"]]
    others = [op for op in MMA_OPS if op != own]
    tf32_ok = (v["HGMMA_TF32"] == v["HGMMA"] if v["chain"] == "tf32"
               else v["HGMMA_TF32"] == 0)
    return (all(v[op] == 0 for op in others) and tf32_ok
            and (v[own] > 0 if v["mma"] else v[own] == 0))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events), after one
    warm-up."""
    from ipu_path_trace_tpu_torch.utils.devtime import time_per_call

    return time_per_call(fn, reps, torch.device("cuda", 0)) * 1e3


def trace_check(name, got, ref, fields=("radiance", "esc_w", "esc_dir")):
    """The flip rule plus the trace tolerance on the unflipped lanes."""
    flipped = (got.path_len != ref.path_len) | (got.escaped != ref.escaped)
    ok_lanes = ~flipped
    frac = float(flipped.float().mean())
    err, bad = 0.0, 0
    for f in fields:
        a, b = getattr(got, f).stack()[:, ok_lanes], getattr(ref, f).stack()[:, ok_lanes]
        err = max(err, float((a - b).abs().max()))
        bad += int(((a - b).abs() > TRACE_ATOL + TRACE_RTOL * b.abs()).sum())
    phase(name, frac < FLIP_FRACTION and bad == 0, flipped_fraction=f"{frac:.2e}",
          out_of_tolerance=bad, max_abs_err=f"{err:.3e}")
    return err


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Relative error, floored at 1% of the reference's peak."""
    return (got - ref).abs() / (ref.abs() + 1e-2 * ref.abs().max())


def nif_rel(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    rel = rel_err(got, ref)
    return float(rel.median()), float(rel.max())


def is_int8(model) -> bool:
    from ipu_path_trace_tpu_torch.models.quant import QuantNifModel

    return isinstance(model, QuantNifModel)


def shade_check(name, model, esc_dir, esc_w, azimuth) -> float:
    """K2 against its plain version: the int8 chain bit for bit, the bf16
    one within the NIF budget."""
    from ipu_path_trace_tpu_torch.ops import nif

    got = nif.nif_env_shade(model, esc_dir, esc_w, azimuth).stack()
    ref = nif.nif_env_shade_plain(model, esc_dir, esc_w, azimuth).stack()
    rel = rel_err(got, ref)
    med, mx = float(rel.median()), float(rel.max())
    above = float((rel > 1e-2).float().mean())
    err = float((got - ref).abs().max())
    ok = torch.equal(got, ref) if is_int8(model) else med < NIF_MEDIAN and mx < NIF_MAX
    phase(name, ok and bool(torch.isfinite(got).all()), equal=torch.equal(got, ref),
          median_rel=f"{med:.2e}", max_rel=f"{mx:.2e}", lanes_above_1e2=f"{above:.2e}",
          max_abs_err=f"{err:.3e}")
    return err


def apply_check(name, model, u, v) -> float:
    """K4 against its plain version: the int8 chain bit for bit, the bf16
    one within the NIF budget."""
    from ipu_path_trace_tpu_torch.ops import nif

    got = nif.nif_apply_t(model, u, v)
    ref = nif.nif_apply_t_plain(model, u, v)
    med, mx = nif_rel(got, ref)
    err = float((got - ref).abs().max())
    ok = torch.equal(got, ref) if is_int8(model) else med < NIF_MEDIAN and mx < NIF_MAX
    phase(name, ok and got.shape == (3, u.shape[0]) and bool(torch.isfinite(got).all()),
          equal=torch.equal(got, ref), median_rel=f"{med:.2e}", max_rel=f"{mx:.2e}",
          max_abs_err=f"{err:.3e}")
    return err


def sum_order_close(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Every element of a within SUM_ORDER_REL of b's (zeros exactly)."""
    return bool(((a - b).abs() <= SUM_ORDER_REL * b.abs()).all())


def megastep_check(name, got, ref, int8: bool) -> float:
    """K3 against its plain version: with the int8 chain the path lengths
    bit for bit and the radiance within the reordered sums' rounding
    (SUM_ORDER_REL); with the bf16 chain the flip rule on the path-length
    sums, the NIF budget on the radiance of the other lanes."""
    flipped = got.path_len != ref.path_len
    frac = float(flipped.float().mean())
    a, b = got.radiance.stack()[:, ~flipped], ref.radiance.stack()[:, ~flipped]
    med, mx = nif_rel(a, b)
    err = float((a - b).abs().max())
    equal = torch.equal(got.path_len, ref.path_len) and sum_order_close(got.radiance.stack(),
                                                                         ref.radiance.stack())
    ok = equal if int8 else frac < FLIP_FRACTION and med < NIF_MEDIAN and mx < NIF_MAX
    phase(name, ok and bool(torch.isfinite(got.radiance.stack()).all()), equal=equal,
          flipped_fraction=f"{frac:.2e}", median_rel=f"{med:.2e}", max_rel=f"{mx:.2e}",
          max_abs_err=f"{err:.3e}")
    return err


def frame_luminance(exr_path: Path) -> tuple[float, float, np.ndarray]:
    """Mean luminance of a saved frame and a conservative Monte-Carlo
    standard error of it: pixel noise variance is bounded by half the
    mean squared difference of horizontal neighbours (image structure
    only adds to that bound)."""
    from ipu_path_trace_tpu_torch.film.imageio import read_exr

    hdr = read_exr(str(exr_path))
    lum = 0.2126 * hdr[..., 0] + 0.7152 * hdr[..., 1] + 0.0722 * hdr[..., 2]
    var = 0.5 * float(np.mean((lum[:, 1:] - lum[:, :-1]) ** 2))
    return float(lum.mean()), math.sqrt(var / lum.size), hdr


def free_port() -> int:
    """A TCP port the kernel just handed out (closed again for the CLI)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def connect_client(port: int, cli_thread: threading.Thread, timeout: float = 300.0):
    """The port's UI client, once the CLI (building, then binding) listens."""
    from ipu_path_trace_tpu_torch.ui import InterfaceClient

    t0 = time.monotonic()
    while True:
        try:
            return InterfaceClient("127.0.0.1", port)
        except OSError:
            if not cli_thread.is_alive() or time.monotonic() - t0 > timeout:
                raise
            time.sleep(0.2)


def wait_for(pred, timeout: float = 120.0) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return False


class SnapshotOn(logging.Handler):
    """Records the K3 launch count when the app logs a message with this
    prefix (the int8 asset's QAT grids loaded by a UI hot swap)."""

    def __init__(self, prefix: str):
        super().__init__()
        self.prefix = prefix
        self.at: int | None = None

    def emit(self, record):
        from ipu_path_trace_tpu_torch.ops import megastep

        if self.at is None and record.getMessage().startswith(self.prefix):
            self.at = megastep.render_megastep.launches


def ui_run(name: str, flags: list[str], out_dir: Path, app_log, counters, plains) -> dict:
    """One CLI run with --ui-port --denoise at the main path's size, driven
    by the port's client in this process: previews, an exposure change (no
    restart), a fov change (the progress restarts), load_nif of the int8
    asset, interactive_samples 16, stop."""
    from ipu_path_trace_tpu_torch.runtime import cli
    from ipu_path_trace_tpu_torch.ui import jpeg
    from ipu_path_trace_tpu_torch.ui.packetcomms import unpack_f32

    port = free_port()
    png = out_dir / f"{name.replace(' ', '_')}.png"
    argv = ["-w", str(MAIN_W), "-H", str(MAIN_H), "-s", str(UI_SPP), "--samples-per-step",
            str(MAIN_SPS), "--assets", str(ROOT / ASSET), "-o", str(png), "--ui-port", str(port),
            "--denoise", *flags]
    steps = UI_SPP // MAIN_SPS
    app_log.lines.clear()
    for f in counters:
        f.launches = 0
    for f in plains:
        f.cuda_runs = 0
    zero_host_calls()
    jpeg.encode_scan_plain.calls = 0
    snap = SnapshotOn("int8 NIF: using QAT activation grids")
    logging.getLogger().addHandler(snap)
    result = {"rc": None}

    def run():
        try:
            result["rc"] = cli.main(argv)
        except Exception as e:  # noqa: BLE001 - the phase reports it and fails
            logging.getLogger(__name__).exception("CLI run %s failed", name)
            result["rc"] = repr(e)

    t0 = time.monotonic()
    thread = threading.Thread(target=run, name=f"cli {name}")
    thread.start()
    info = {}
    client = None
    try:
        client = connect_client(port, thread)
        progress: list[float] = []
        client._rx.subscribe("progress", lambda b: progress.append(unpack_f32(b)))
        first = float(np.float32(1.0 / steps))  # step 1's progress as the wire's f32
        info["previews"] = wait_for(lambda: client.preview_count >= 3)
        mark = len(progress)
        client.set_exposure(0.5)
        wait_for(lambda: len(progress) >= mark + 4)
        after = progress[mark:mark + 4]
        info["exposure_no_restart"] = len(after) == 4 and all(
            b > a for a, b in zip(after, after[1:]))
        mark = len(progress)
        client.set_fov(70.0)
        info["fov_restart"] = wait_for(lambda: first in progress[mark:])
        mark = len(progress)
        client.load_nif(str(ROOT / INT8_ASSET))
        info["load_nif_restart"] = wait_for(lambda: first in progress[mark:])
        wait_for(lambda: len(progress) >= mark + 3)
        mark = len(progress)
        client.set_interactive_samples(16)
        info["samples_16_restart"] = wait_for(lambda: first in progress[mark:])
        wait_for(lambda: len(progress) >= mark + 4)
        info["preview_count"] = client.preview_count
        info["stream_bytes"] = len(client.preview_stream)
        frames = client.preview_images()  # MJPEG frames decode; H.264 stays raw
        info["decoded_frames"] = len(frames)
        info["frames_ok"] = all(f.shape == (MAIN_H, MAIN_W, 3) for f in frames[-1:])
        client.stop_render()
        thread.join(300)
    finally:
        if client is not None:
            client.close()
        logging.getLogger().removeHandler(snap)
    info["wall_s"] = time.monotonic() - t0
    info["rc"] = result["rc"]
    info["alive"] = thread.is_alive()
    info["launches"] = dict(zip(("trace", "env_shade", "megastep", "nif_apply"),
                                (f.launches for f in counters)))
    info["plain_runs_on_cuda"] = [f.cuda_runs for f in plains]
    info["host_calls"] = {**host_calls(), "jpeg_plain": jpeg.encode_scan_plain.calls}
    info["int8_launches_after_swap"] = (None if snap.at is None
                                        else info["launches"]["megastep"] - snap.at)
    info["step_s"] = app_log.seconds("Completed render step")
    info["png"] = png
    return info


def ui_components(out_dir: Path, smi: str, counters, plains) -> dict:
    """Phase 6d's checks and times of the UI path's parts at the main
    path's size: the guides (K4) against their plain version, the device's
    denoised preview against denoise_hdr and the native tone map of the
    fetched film, the preview, denoise and JPEG times, and a --denoise save
    and every --debug-view mode through the CLI."""
    from ipu_path_trace_tpu_torch.core.records import raster_permutation, to_device_batch
    from ipu_path_trace_tpu_torch.film.debugview import DEBUG_VIEWS, debug_view
    from ipu_path_trace_tpu_torch.film.denoise import (ALBEDO_FLOOR, denoise_hdr, filter_hdr,
                                                       guides_numpy)
    from ipu_path_trace_tpu_torch.film.film import Film
    from ipu_path_trace_tpu_torch.film.imageio import read_exr
    from ipu_path_trace_tpu_torch.ops import nif
    from ipu_path_trace_tpu_torch.render.wavefront import render_step
    from ipu_path_trace_tpu_torch.runtime import app as app_mod
    from ipu_path_trace_tpu_torch.runtime import cli, native
    from ipu_path_trace_tpu_torch.ui import jpeg

    dev = torch.device("cuda", 0)
    base = ["-w", str(MAIN_W), "-H", str(MAIN_H), "-s", str(MAIN_SPS), "--samples-per-step",
            str(MAIN_SPS), "--assets", str(ROOT / ASSET)]
    cfg = cli.parse_config(base + ["-o", str(out_dir / "ui_parts.png"), "--denoise"])
    app = app_mod.PathTracerApp(cfg)
    app.init()
    app.build()
    nif.nif_apply_t.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    guides = app._guides(app.state)  # cold: what a restart under --denoise pays
    torch.cuda.synchronize()
    guides_ms = (time.perf_counter() - t0) * 1e3
    k4 = nif.nif_apply_t.launches
    sky = ~guides["hit"].reshape(-1)
    n_sky = int(sky.sum())
    uv = guides["escape_uv"].reshape(-1, 2)[sky]
    ref = nif.nif_apply_t_plain(app.env.model, uv[:, 0].contiguous(), uv[:, 1].contiguous())
    got = guides["albedo"].reshape(-1, 3)[sky]
    rel = rel_err(got, ref.flip(0).t())
    med, mx = float(rel.median()), float(rel.max())
    tail = float((rel > NIF_MAX).float().mean())
    phase("ui guides K4 vs plain", k4 == -(-n_sky // cfg.max_nif_batch_size)
          and med < NIF_MEDIAN and tail <= NIF_TAIL_FRACTION and mx < NIF_TAIL_MAX
          and bool(torch.isfinite(guides["albedo"]).all()),
          k4_launches=k4, sky_pixels=n_sky, median_rel=f"{med:.2e}", max_rel=f"{mx:.2e}",
          lanes_past_8e2=f"{tail:.2e}")

    work = to_device_batch(app.worklist, dev)
    work = render_step(app.scene, app.settings(), app.static_config(), work, (7, 8), app.env)
    perm = torch.from_numpy(raster_permutation(app.worklist, MAIN_W, MAIN_H)
                            .astype(np.int64)).to(dev)
    pg = (torch.clamp_min(guides["albedo"], ALBEDO_FLOOR), guides["normal"], guides["disparity"])
    kw = dict(width=MAIN_W, height=MAIN_H)
    dn = dict(iterations=cfg.denoise_iters)

    def preview_dn():
        return app_mod._device_preview_denoised(work, perm, 0.0, 2.2, *pg, cfg.denoise_sigma,
                                                cfg.denoise_clamp, **kw, **dn)

    dev_ldr = preview_dn().cpu().numpy()
    soa = app._fetch(work, None)
    film = Film(MAIN_W, MAIN_H)
    film.accumulate_soa(soa["u"], soa["v"], soa["r"], soa["g"], soa["b"], soa["sample_count"])
    host_hdr = denoise_hdr(film.hdr_at_step(1), guides, iterations=cfg.denoise_iters,
                           sigma_colour=cfg.denoise_sigma, firefly_clamp=cfg.denoise_clamp,
                           device=dev)
    host_ldr = native.tonemap(host_hdr, 0.0, 2.2)
    diff = int(np.abs(dev_ldr.astype(int) - host_ldr.astype(int)).max())
    phase("ui device denoised preview = denoise_hdr + native tone map", diff <= 1
          and dev_ldr.shape == (MAIN_H, MAIN_W, 3) and bool(np.isfinite(host_hdr).all()),
          max_code_diff=diff, mean_ldr=f"{dev_ldr.mean():.3f}")

    hdr_t = app_mod._raster_mean(work, perm, MAIN_W, MAIN_H)
    times = {
        "device_preview_ms": cuda_ms(lambda: app_mod._device_preview(work, perm, 0.0, 2.2, **kw),
                                     20),
        "device_preview_denoised_ms": cuda_ms(preview_dn, 5),
        "denoise_ms": cuda_ms(lambda: filter_hdr(hdr_t, *pg, sigma_colour=cfg.denoise_sigma,
                                                 firefly_clamp_k=cfg.denoise_clamp, **dn), 5),
        "guides_ms": guides_ms,
    }
    state = dict(app.state)
    app._preview(work, perm, state)  # the loop's call: the preview and its fetch, warm
    t0 = time.perf_counter()
    for _ in range(5):
        app._preview(work, perm, state)
    times["preview_denoised_and_fetch_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    jpeg.encode(dev_ldr)
    t0 = time.perf_counter()
    for _ in range(5):
        sample = jpeg.encode(dev_ldr)
    times["jpeg_encode_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    times["jpeg_bytes"] = len(sample)
    decoded = jpeg.decode(sample)
    psnr = 10 * math.log10(255.0 ** 2 / max(float(np.mean(
        (decoded.astype(float) - dev_ldr.astype(float)) ** 2)), 1e-12))
    phase("ui native JPEG of the preview decodes", decoded.shape == dev_ldr.shape and psnr > 30.0,
          bytes=len(sample), psnr_db=f"{psnr:.2f}")
    print(f"[timing] ui parts at {MAIN_W}x{MAIN_H} ({smi}): " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in times.items()),
        flush=True)

    # A --denoise save and every --debug-view mode through the CLI.
    host_guides = guides_numpy(guides)
    saves = {}
    for extra in (["--denoise"], *(["--debug-view", m] for m in DEBUG_VIEWS)):
        name = "_".join(e.lstrip("-") for e in extra)
        png = out_dir / f"save_{name}.png"
        for f in counters:
            f.launches = 0
        for f in plains:
            f.cuda_runs = 0
        rc = cli.main(base + ["-o", str(png), *extra])
        hdr = read_exr(str(png.with_suffix(".exr")))
        got = [f.launches for f in counters]
        ok = (rc == 0 and png.exists() and hdr.shape == (MAIN_H, MAIN_W, 3)
              and bool(np.isfinite(hdr).all()) and got[2] == 1 and got[3] > 0
              and not any(f.cuda_runs for f in plains))
        info = {}
        if extra[0] == "--debug-view" and extra[1] != "path-length":
            same = np.array_equal(hdr, debug_view(extra[1], host_guides))
            info["equals_guides_view"] = same
            ok = ok and same
        elif extra[0] == "--debug-view":
            info["range"] = f"[{hdr.min():.3f}, {hdr.max():.3f}]"
            ok = ok and hdr.min() >= 0.1 - 1e-6 and hdr.max() <= 1.0
        phase(f"ui save {' '.join(extra)} {MAIN_W}x{MAIN_H}", ok, rc=rc,
              launches_trace_shade_megastep_apply=got, **info)
        saves[name] = got
    times["saves_launches"] = saves
    return times


def train_phase(out_dir: Path, smi: str, dev, counters, plains, scene, k3_args) -> dict:
    """Phase 6f: train, check, use and quantise NIF assets with the port's
    tools on the card.  ``k3_args`` = (cols, rows, settings, kw) of phase
    5's 256x256 checks.  Returns the phase's numbers and its K3/K4 errors."""
    from ipu_path_trace_tpu_torch.models import reconstruct, train_nif
    from ipu_path_trace_tpu_torch.models.nif import load_nif_assets
    from ipu_path_trace_tpu_torch.models.quant import qat_finetune, quantize_nif
    from ipu_path_trace_tpu_torch.models.synth_env import resolve_synth
    from ipu_path_trace_tpu_torch.ops import megastep, nif
    from ipu_path_trace_tpu_torch.probes import quant_psnr, train_replay
    from ipu_path_trace_tpu_torch.runtime import cli
    from ipu_path_trace_tpu_torch.runtime.app import parse_env_assets
    from ipu_path_trace_tpu_torch.tools.quant_qat import save_qat_asset

    res, err = {}, {}
    t6f = time.monotonic()
    cmd = train_replay.recorded_command(ROOT / ASSET)
    trained = out_dir / "trained_nif"
    shutil.rmtree(trained, ignore_errors=True)
    argv = [*cmd[3:], "--epochs", str(TRAIN_EPOCHS), "--device", "cuda"]
    argv[1] = str(trained)
    # (a) the trainer's CLI on the card; TF32 on outside it, off in its steps
    seen_tf32 = []
    step = train_nif.train_step

    def spy(*a, **k):
        seen_tf32.append(torch.backends.cuda.matmul.allow_tf32)
        return step(*a, **k)

    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    train_nif.train_step = spy
    record = {}
    try:
        t0 = time.monotonic()
        rc = train_nif.main(argv, record=record)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        restored = torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        train_nif.train_step = step
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    weights = load_nif_assets(str(trained))[2]
    bound = train_replay.step_bound_ms(weights, 65536)
    med = statistics.median(record.get("step_ms", [0.0]))
    losses = record.get("losses", [float("nan")])
    steps = TRAIN_EPOCHS * 2
    res["train"] = {"seconds": secs, "steps": len(losses), "median_step_ms": med,
                    "step_bound_ms": bound, "first_loss": losses[0], "final_loss": losses[-1]}
    print(f"[timing] train 6x320 on the card ({smi}): {steps} steps of 65,536 in {secs:.1f} s "
          f"(with the 2048x4096 synth), median step {med:.3f} ms, bound {bound:.3f} ms "
          f"(f32 products at 67 TFLOP/s), loss {losses[0]:.5f} -> {losses[-1]:.5f}", flush=True)
    phase("train: trainer CLI on the card", rc == 0 and len(losses) == steps
          and losses[0] >= TRAIN_LOSS_DROP * losses[-1] and all(map(math.isfinite, losses))
          and seen_tf32 == [False] * steps and restored,
          steps=len(losses), first_loss=f"{losses[0]:.5f}", final_loss=f"{losses[-1]:.5f}",
          tf32_in_steps=sorted(set(seen_tf32)), tf32_restored=restored,
          median_step_ms=f"{med:.3f}", bound_ms=f"{bound:.3f}")

    # (b) the card's first steps against the CPU's on the same params and batches
    img = resolve_synth(cmd[3])
    uv, y, _, _ = train_nif.uv_targets(img, 1e-8, True, "cpu")
    dims = train_nif.layer_dims([320] * 6, 12, 3)
    modules, opts = {}, {}
    for d in ("cpu", dev):
        kernels, biases = train_nif.init_params(dims, 0)
        modules[d] = train_nif.NifMLP(kernels, biases, 12, 3).to(d)
        opts[d] = train_nif.make_optimizer(modules[d], 1e-3, steps)
    gen = torch.Generator().manual_seed(1)
    uv_d, y_d = uv.to(dev), y.to(dev)
    rel_losses = []
    with train_nif.exact_f32():
        for _ in range(TRAIN_CPU_STEPS):
            idx = torch.randint(0, uv.shape[0], (65536,), generator=gen)
            lc = float(train_nif.train_step(modules["cpu"], *opts["cpu"], uv[idx], y[idx]))
            idx_d = idx.to(dev)
            lg = float(train_nif.train_step(modules[dev], *opts[dev], uv_d[idx_d], y_d[idx_d]))
            rel_losses.append(abs(lg - lc) / abs(lc))
    diffs = torch.cat([(a.detach().cpu() - b.detach()).abs().flatten() / 1e-3 for a, b in
                       zip(modules[dev].parameters(), modules["cpu"].parameters())])
    p_med, p_max = float(diffs.median()), float(diffs.max())
    p_above = float((diffs > TRAIN_PARAM_ABOVE).float().mean())
    res["card_vs_cpu"] = {"loss_rel": rel_losses, "param_median_lr": p_med,
                          "param_max_lr": p_max, "param_above_frac": p_above}
    phase(f"train: {TRAIN_CPU_STEPS} card steps = CPU steps", max(rel_losses) <= TRAIN_LOSS_RTOL
          and p_med <= TRAIN_PARAM_MEDIAN and p_above <= TRAIN_PARAM_FRACTION,
          loss_rel=[f"{r:.2e}" for r in rel_losses], param_median_lr=f"{p_med:.2e}",
          param_above_frac=f"{p_above:.2e}", param_max_lr=f"{p_max:.2e}")
    del modules, opts, uv_d, y_d

    # (c) the trained asset: reload, the quality gate through K4 (and its
    # plain version), a fused 1104x1000 render through K3
    model, meta, _ = load_nif_assets(str(trained), torch.bfloat16, dev)
    nif.nif_apply_t.launches = nif.nif_apply_t_plain.cuda_runs = 0
    t0 = time.monotonic()
    quality = quant_psnr.main(["--assets", str(trained)])
    gate_launches = nif.nif_apply_t.launches
    kernel_apply = nif.nif_apply_t
    reconstruct.nif_apply_t = quant_psnr.nif_apply_t = nif.nif_apply_t_plain
    try:
        quality_plain = quant_psnr.main(["--assets", str(trained)])
    finally:
        reconstruct.nif_apply_t = quant_psnr.nif_apply_t = kernel_apply
    gate_s = time.monotonic() - t0
    gaps = {k: abs(quality[k] - quality_plain[k])
            for k in ("bf16_psnr_db", "int8_psnr_db", "f32_psnr_db")}
    res["gate"] = {"k4": quality, "plain": quality_plain, "seconds": gate_s}
    phase("train: reloaded asset, quality gate K4 vs plain", meta.hidden_size == 320
          and model.layer_plan()[3][2] and gate_launches > 0
          and nif.nif_apply_t_plain.cuda_runs == gate_launches
          and all(g <= PSNR_GAP_DB and math.isfinite(quality[k]) for k, g in gaps.items()),
          hidden_size=meta.hidden_size, k4_launches=gate_launches,
          **{k: f"{quality[k]:.4f}" for k in gaps}, gaps_db=[f"{g:.1e}" for g in gaps.values()],
          seconds=f"{gate_s:.1f}")
    print(f"[train] the trained asset's gate ({smi}): bf16 {quality['bf16_psnr_db']:.4f} dB, "
          f"int8 PTQ {quality['int8_psnr_db']:.4f}, f32 {quality['f32_psnr_db']:.4f} "
          f"after {steps} steps", flush=True)
    png = out_dir / "trained_render.png"
    for f in counters:
        f.launches = 0
    for f in plains:
        f.cuda_runs = 0
    rc = cli.main(["-w", str(MAIN_W), "-H", str(MAIN_H), "-s", str(MAIN_SPS),
                   "--samples-per-step", str(MAIN_SPS), "--assets", str(trained), "-o", str(png)],
                  use_fused_step=True)
    got = [f.launches for f in counters]
    hdr = frame_luminance(png.with_suffix(".exr"))[2] if rc == 0 else np.zeros((1, 1, 3))
    phase("train: render with the trained asset (K3)", rc == 0 and got[2] > 0
          and not any(f.cuda_runs for f in plains) and hdr.shape == (MAIN_H, MAIN_W, 3)
          and bool(np.isfinite(hdr).all()), launches_trace_shade_megastep_apply=got,
          mean=f"{float(hdr.mean()):.5f}")

    # (d) QAT on the card from the shipped bf16 asset, then the int8 chain
    _, smeta, sweights = load_nif_assets(str(ROOT / ASSET))
    qrecord = {}
    t0 = time.monotonic()
    qat_w, amax, qloss = qat_finetune(sweights, smeta, img, epochs=QAT_EPOCHS, batch_size=65536,
                                      train_samples=131072, learning_rate=2e-4, seed=0,
                                      device=dev, record=qrecord)
    torch.cuda.synchronize()
    qsecs = time.monotonic() - t0
    qmed = statistics.median(qrecord["step_ms"])
    res["qat"] = {"seconds": qsecs, "median_step_ms": qmed, "first_loss": qrecord["losses"][0],
                  "final_loss": qloss, "amax": list(amax)}
    print(f"[timing] QAT 6x320 on the card ({smi}): {len(qrecord['step_ms'])} steps in "
          f"{qsecs:.1f} s, median step {qmed:.3f} ms, loss {qrecord['losses'][0]:.6f} -> "
          f"{qloss:.6f}", flush=True)
    q8 = quantize_nif(qat_w, smeta, amax=amax, device=dev)
    gen_np = np.random.default_rng(2026)
    u, v = (torch.from_numpy(gen_np.uniform(0.0, 1.0, (2, 65536)).astype(np.float32)).to(dev))
    err["nif_apply_int8"] = apply_check("train: K4 int8 on the QAT weights", q8, u, v)
    cols, rows, settings, kw = k3_args
    err["megastep_int8"] = megastep_check(
        "train: K3 int8 philox on the QAT weights",
        megastep.render_megastep(scene, settings, q8, cols, rows, (21, 22), **kw),
        megastep.render_megastep_plain(scene, settings, q8, cols, rows, (21, 22), **kw), True)
    qdir = out_dir / "qat_nif"
    shutil.rmtree(qdir, ignore_errors=True)
    save_qat_asset(str(qdir), qat_w, smeta, amax, "256x512", ["chip_smoke.py", "phase 6f"])
    # the asset stores the weights in f16, as the shipped one; the app's
    # int8 load must quantise those with the fine-tune's grids
    back = parse_env_assets(str(qdir), dev, "int8")[0].model
    want = quantize_nif(load_nif_assets(str(qdir))[2], smeta, amax=amax, device=dev)
    same = all(torch.equal(a, b) for a, b in zip(
        [*back.kernels, *back.biases, *back.mults, back.mult_skip, back.inv_next],
        [*want.kernels, *want.biases, *want.mults, want.mult_skip, want.inv_next]))
    phase("train: QAT on the card, saved and reloaded int8", same and math.isfinite(qloss)
          and len(qrecord["step_ms"]) == 2 * QAT_EPOCHS, reloaded_equal=same,
          first_loss=f"{qrecord['losses'][0]:.6f}", final_loss=f"{qloss:.6f}",
          seconds=f"{qsecs:.1f}")
    print(f"[timing] phase 6f (the NIF tools): {time.monotonic() - t6f:.1f} s", flush=True)
    return {"numbers": res, "err": err}


def accuracy_phase(out_dir: Path, smi: str, dev, counters, plains) -> dict:
    """Phase 10, the accuracy acceptance and the wide chains: (a) exact
    replay against the port's NumPy oracle (probes/validate_rmse.py at
    cut sizes, each config's criterion), (b) probes/validate_gpu.py's
    statistical checks at cut sizes, (c) hidden width 384 - K2, K3 and K4
    in the three chains against their plain versions (probes/wide_chain.py)
    and a fused CLI render with a 6x384 asset written here, (d) each NIF
    tool once at a cut size, its JSON under the phase's directory.  Returns
    the phase's numbers."""
    from ipu_path_trace_tpu_torch.models.nif import make_synthetic_nif
    from ipu_path_trace_tpu_torch.models.train_nif import save_assets
    from ipu_path_trace_tpu_torch.probes import encode_ab, validate_gpu, validate_rmse, wide_chain
    from ipu_path_trace_tpu_torch.runtime import cli
    from ipu_path_trace_tpu_torch.tools import (nif_hard_env_check, nif_multienv,
                                                nif_reference_scale, nif_width_sweep)

    res = {"seconds": {}}
    acc_dir = out_dir / "accuracy"
    shutil.rmtree(acc_dir, ignore_errors=True)
    acc_dir.mkdir(parents=True)
    workers = os.cpu_count() or 1

    # (a) exact replay against the oracle, K1 (+ eval_env), K3 and K1 + K2
    t0 = time.monotonic()
    res["oracle"] = []
    for name, size, spp in (("config1_diffuse", (128, 128), 16), ("north_star", (128, 128), 64),
                            ("config2_texture", None, 1), ("config3_nif", None, 1)):
        for path in validate_rmse.paths(name):
            e = validate_rmse.run_config(name, size, "cuda", path, workers, spp)
            res["oracle"].append(e)
            ran = e["launches"]
            kernels_ran = (ran["megastep"] > 0 if path == "fused" else
                           ran["trace"] >= spp and ran["megastep"] == 0
                           and (ran["env_shade"] >= spp) == (name == "config3_nif"))
            phase(f"oracle {name} {e['width']}x{e['height']} @ {spp} spp {path} ({e['kernels']})",
                  e["pass"] and kernels_ran, launches=ran, rmse=f"{e['rmse']:.3e}",
                  rmse_absolute=f"{e['rmse_absolute']:.3e}",
                  rmse_agreeing_lanes=f"{e['rmse_agreeing_lanes']:.3e}",
                  diverged_fraction=f"{e['diverged_pixel_fraction']:.2e}",
                  oracle_s=f"{e['oracle_seconds']:.1f}")
    res["seconds"]["a"] = time.monotonic() - t0

    # (b) the statistical checks: fused (Philox in K3) against unfused host
    # noise, at the script's 256 spp (with fewer samples the noise alone can
    # carry a check's cross / floor past the rule: PERF.md §6)
    t0 = time.monotonic()
    res["validate_gpu"] = validate_gpu.checks(spp=256, device=dev, nif_size=(128, 128),
                                              texture_size=(256, 256))
    for c in res["validate_gpu"]:
        phase(f"validate_gpu {c['name']}", c["pass"], floor=f"{c['floor']:.5f}",
              cross=f"{c['cross']:.5f}", bound=f"{1.5 * c['floor'] + 1e-4:.5f}")
    res["seconds"]["b"] = time.monotonic() - t0

    # (c) hidden width 384: the chains against their plain versions, then a
    # fused CLI render with a 6x384 asset
    t0 = time.monotonic()
    res["wide_checks"] = wide_chain.checks(dev)
    for c in res["wide_checks"]:
        phase(c["name"], c["ok"], **{k: f"{v:.3e}" if isinstance(v, float) else v
                                     for k, v in c.items() if k not in ("name", "ok")})
    res["wide_times_ms"] = wide_chain.times(dev)
    print(f"[timing] width 384 ({smi}): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in res["wide_times_ms"].items())
        + " (K3 per 1104x1000 sample; PERF.md's earlier K3 bf16 on the canonical asset on "
        "this card: 3.058 ms)",
        flush=True)
    weights, meta = make_synthetic_nif(wide_chain.NET_SEED, hidden=384)
    wide_asset = acc_dir / "nif_w384_synthetic"
    save_assets(str(wide_asset), weights, meta, ["chip_smoke.py", "phase 10c"])
    png = acc_dir / "w384_render.png"
    for f in counters:
        f.launches = 0
    for f in plains:
        f.cuda_runs = 0
    rc = cli.main(["-w", str(MAIN_W), "-H", str(MAIN_H), "-s", str(MAIN_SPS),
                   "--samples-per-step", str(MAIN_SPS), "--assets", str(wide_asset),
                   "-o", str(png)], use_fused_step=True)
    got = [f.launches for f in counters]
    hdr = frame_luminance(png.with_suffix(".exr"))[2] if rc == 0 else np.zeros((1, 1, 3))
    res["wide_cli"] = {"rc": rc, "launches_trace_shade_megastep_apply": got,
                       "mean": float(hdr.mean())}
    phase("CLI fused render with a 6x384 asset (K3)", rc == 0 and got[2] == 1
          and not any(f.cuda_runs for f in plains) and hdr.shape == (MAIN_H, MAIN_W, 3)
          and bool(np.isfinite(hdr).all()) and float(hdr.mean()) > 0,
          launches_trace_shade_megastep_apply=got, mean=f"{float(hdr.mean()):.5f}")
    res["seconds"]["c"] = time.monotonic() - t0

    # (d) the NIF tools once each, cut: 20 epochs, one arch, 256x512 envs;
    # the reference-scale tool and the encode A/B on phase 6f's 2048x4096
    # synth, last, so that phase 9 finds it cached (models/synth_env keeps one)
    t0 = time.monotonic()
    tools = (("nif_multienv", nif_multienv.main,
              ["--archs", "192", "--seeds", "13", "--epochs", "20", "--size", "256x512"],
              "nif_multienv.json"),
             ("nif_hard_env_check", nif_hard_env_check.main,
              ["--widths", "192", "--epochs", "20", "--size", "256x512"], "nif_hard_env.json"),
             ("nif_width_sweep", nif_width_sweep.main,
              ["--widths", "384", "--epochs", "20"], "nif_widths.json"),
             ("nif_reference_scale", nif_reference_scale.main,
              ["--archs", "192e16", "--epochs", "20"], "nif_reference_scale.json"),
             ("encode_ab", encode_ab.main, ["--grid", "256x512"], "encode_ab.json"))
    res["tools"] = {}
    for name, tool, argv, json_name in tools:
        tool_out = acc_dir / name
        t1 = time.monotonic()
        rc = tool(argv + ["--out", str(tool_out)])
        doc_path = tool_out / json_name
        doc = json.loads(doc_path.read_text()) if doc_path.is_file() else None
        res["tools"][name] = {"doc": doc, "seconds": time.monotonic() - t1}
        psnrs = re.findall(r'"\w*psnr\w*": (-?[0-9.]+)', json.dumps(doc))
        ok = doc is not None and (rc == 0 or isinstance(rc, dict))  # encode_ab returns its doc
        phase(f"NIF tool {name}", ok and bool(psnrs) and all(math.isfinite(float(x))
                                                            for x in psnrs),
              json=str(doc_path.relative_to(ROOT)), psnr_db=psnrs,
              seconds=f"{time.monotonic() - t1:.1f}")
    res["seconds"]["d"] = time.monotonic() - t0
    print(f"[timing] phase 10 (a-d): " + ", ".join(f"{k} {v:.1f} s"
                                                  for k, v in res["seconds"].items()), flush=True)
    return res


def mesh_phase(out_dir: Path, smi: str, dev, counters, plains, app_log, main_lum: dict,
               main_split: dict, bake_chunks: int) -> dict:
    """Phase 11, the device mesh (parallel/mesh.py) on one card: (a)
    probes/validate_mesh.py's 1x1 mesh against the mesh-less render, bit
    for bit, bf16 and int8, Philox, Sobol and adaptive; (b) the virtual
    8x1, 4x2 and 2x4 meshes on cuda:0 against their replay, fused and
    unfused, each with a step under set_sync_debug_mode("error"), then the
    K3 step of the mesh-less render, the 1x1 and the virtual meshes timed;
    (c) the CLI with --mesh-shape 1x1 (host film, device film, unfused,
    baked, --device-timing), counters zeroed before each run and read after,
    each frame within 5 SE of the mesh-less run of phase 6; (d) --ipus one
    more than the GPUs exits non-zero naming both counts; (e) with two
    GPUs or more, 2x1 and 1x2 meshes over two of them (NCCL) against the
    replay, else one line saying it did not run."""
    from ipu_path_trace_tpu_torch.core.records import to_device_batch
    from ipu_path_trace_tpu_torch.core.scene import default_scene
    from ipu_path_trace_tpu_torch.ops import megastep
    from ipu_path_trace_tpu_torch.parallel.mesh import (make_mesh, parse_mesh_shape, replicate,
                                                        shard_work, sharded_render_step)
    from ipu_path_trace_tpu_torch.probes import validate_mesh
    from ipu_path_trace_tpu_torch.render.params import RenderSettings, StaticConfig
    from ipu_path_trace_tpu_torch.render.wavefront import render_step
    from ipu_path_trace_tpu_torch.runtime import cli
    from ipu_path_trace_tpu_torch.utils.devtime import time_per_call

    t11 = time.monotonic()
    res = {"seconds": {}, "cli": {}}

    def report(checks):
        for c in checks:
            phase(c["name"], c["ok"], **{k: f"{v:.3e}" if isinstance(v, float) else v
                                         for k, v in c.items() if k not in ("name", "ok")})

    # (a) the 1x1 mesh against the mesh-less render
    t0 = time.monotonic()
    envs = validate_mesh.load_envs(dev)
    res["a"] = validate_mesh.run_1x1(dev, MAIN_W, MAIN_H, MAIN_SPS, envs)
    report(res["a"])
    res["seconds"]["a"] = time.monotonic() - t0

    # (b) virtual meshes on cuda:0 against the replay, then the step times
    t0 = time.monotonic()
    res["b"] = validate_mesh.run_virtual(dev, validate_mesh.SHAPES, MAIN_W, MAIN_H, MAIN_SPS,
                                         envs["bf16"])
    report(res["b"])
    scene, env = default_scene(dev), envs["bf16"]
    cfg = StaticConfig(width=MAIN_W, height=MAIN_H)
    seed = validate_mesh.SEED
    work = to_device_batch(validate_mesh.worklist(MAIN_W, MAIN_H, scene), dev)
    step_ms = {"mesh-less": time_per_call(lambda: render_step(
        scene, RenderSettings.make(samples_per_step=MAIN_SPS), cfg, work, seed, env), 5,
        dev) * 1e3 / MAIN_SPS}
    for shape in ("1x1", "4x2", "2x4"):
        n = math.prod(int(x) for x in shape.split("x"))
        px, sm = parse_mesh_shape(shape, n)
        m = make_mesh(n, shape, [dev] * n)
        args = (replicate(scene, m), RenderSettings.make(samples_per_step=MAIN_SPS // sm), cfg,
                shard_work(to_device_batch(validate_mesh.worklist(MAIN_W, MAIN_H, scene, px),
                                           dev), m), seed, replicate(env, m), m)
        step_ms[shape] = time_per_call(lambda a=args: sharded_render_step(*a), 5,
                                       dev) * 1e3 / MAIN_SPS
    res["step_ms_per_sample"] = step_ms
    print(f"[timing] mesh K3 step per 1104x1000 sample ({MAIN_SPS} samples a step, bf16; "
          f"{smi}): " + ", ".join(f"{k} {v:.4f} ms" for k, v in step_ms.items()), flush=True)
    res["seconds"]["b"] = time.monotonic() - t0

    # (c) the CLI on a 1x1 mesh, each run beside its mesh-less twin of phase 6
    t0 = time.monotonic()
    steps = MAIN_SPP // MAIN_SPS
    fused_want = [0, 0, steps, 0]  # K3 a step
    runs = [("mesh 1x1 fused", [], True, fused_want, "main fused"),
            ("mesh 1x1 device film", ["--device-film"], True, fused_want, "device film"),
            ("mesh 1x1 unfused", [], False, [MAIN_SPP, MAIN_SPP, 0, 0], "main unfused"),
            ("mesh 1x1 baked", ["--nif-mode", "baked"], True, [MAIN_SPP, 0, 0, bake_chunks],
             "main baked"),
            ("mesh 1x1 device timing", ["--device-timing"], True, [0, 0, steps + 3, 0], None)]
    for name, flags, fused, want, twin in runs:
        png = out_dir / f"{name.replace(' ', '_')}.png"
        app_log.lines.clear()
        for f in counters:
            f.launches = 0
        for f in plains:
            f.cuda_runs = 0
        megastep.render_megastep.stub_launches = dict.fromkeys(megastep.STUBS, 0)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        rc = cli.main(["-w", str(MAIN_W), "-H", str(MAIN_H), "-s", str(MAIN_SPP),
                       "--samples-per-step", str(MAIN_SPS), "--assets", str(ROOT / ASSET),
                       "-o", str(png), "--mesh-shape", "1x1", *flags], use_fused_step=fused)
        torch.cuda.synchronize()
        secs = time.monotonic() - t1
        got = [f.launches for f in counters]
        plain_cuda = [f.cuda_runs for f in plains]
        mean, se, hdr = frame_luminance(png.with_suffix(".exr"))
        per_chip = [ln for ln in app_log.lines if ln.startswith("Samples/sec/chip: ")]
        ok = (rc == 0 and got == want and not any(plain_cuda) and len(per_chip) == 1
              and any(ln.startswith("Device mesh: {'pixels': 1, 'samples': 1}")
                      for ln in app_log.lines)
              and bool(np.isfinite(hdr).all()) and hdr.shape == (MAIN_H, MAIN_W, 3))
        info = {"launches_trace_shade_megastep_apply": got, "plain_runs_on_cuda": plain_cuda,
                "mean_luminance": f"{mean:.6f}", "mc_se": f"{se:.2e}", "wall_s": f"{secs:.2f}",
                "per_chip": per_chip[0] if per_chip else None}
        if twin is not None:
            gap = abs(mean - main_lum[twin][0])
            bound = 5.0 * math.hypot(se, main_lum[twin][1])
            ok = ok and gap <= bound
            info.update(mesh_less=twin, luminance_gap=f"{gap:.3e}", bound_5se=f"{bound:.3e}")
        else:
            stubs = dict(megastep.render_megastep.stub_launches)
            splits = app_log.phase_splits()
            split = splits[-1] if splits else {}
            parts = [split.get(k, 0.0) for k in ("env_ms", "trace_ms", "overhead_ms")]
            ok = (ok and len(splits) == 1 and all(x > 0 for x in parts)
                  and abs(sum(parts) - split.get("step_ms", 0.0)) <= 2e-3
                  and stubs == {"nif": 3, "trace": 0, "both": 3})
            info.update(stub_launches=stubs, split=split)
            res["split"] = split
            print(f"[timing] device phase split, 1x1 mesh beside mesh-less ({smi}): step "
                  f"{split.get('step_ms', 0.0):.4f} vs {main_split.get('step_ms', 0.0):.4f} ms "
                  f"a sample, {json.dumps(split)}", flush=True)
        res["cli"][name] = info
        phase(name, ok, **info)
    res["seconds"]["c"] = time.monotonic() - t0

    # (d) one GPU more than the machine has
    t0 = time.monotonic()
    n = torch.cuda.device_count()
    proc = subprocess.run(
        [sys.executable, "-m", "ipu_path_trace_tpu_torch.runtime.cli", "-w", "64", "-H", "48",
         "-s", "1", "--samples-per-step", "1", "--assets", str(ROOT / ASSET),
         "-o", str(out_dir / "ipus.png"), "--ipus", str(n + 1)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    want = f"Requested {n + 1} GPUs but only {n} available"
    phase(f"--ipus {n + 1} on {n} GPU(s) refused", proc.returncode != 0 and want in proc.stderr
          and not (out_dir / "ipus.png").exists(), rc=proc.returncode,
          message=want if want in proc.stderr else proc.stderr[-300:])
    res["seconds"]["d"] = time.monotonic() - t0

    # (e) distinct GPUs: NCCL across the sample replicas
    if n >= 2:
        t0 = time.monotonic()
        res["e"] = validate_mesh.run_virtual(dev, ("2x1", "1x2"), MAIN_W, MAIN_H, MAIN_SPS,
                                             envs["bf16"], devices=[dev, torch.device("cuda", 1)])
        report(res["e"])
        res["seconds"]["e"] = time.monotonic() - t0
    else:
        print(f"[mesh] phase 11e not run: {n} GPU on this machine; the 2x1 and 1x2 meshes over "
              "distinct GPUs (NCCL) need two. Neither PASS nor FAIL.", flush=True)
    res["seconds"]["total"] = time.monotonic() - t11
    print(f"[timing] phase 11 (mesh): " + ", ".join(f"{k} {v:.1f} s"
                                                    for k, v in res["seconds"].items())
          + f" ({smi})", flush=True)
    return res


STUDY_CUT = ["--width", "368", "--height", "336"]  # phase 12: Group 1 at a cut frame
STUDY_COUNTS_CHECK = (16, 16)  # phase 12: each scene count's K3 against plain at 16x16 rays


def study_phase(out_dir: Path, smi: str, dev, counters, plains) -> dict:
    """Phase 12, the studies (probes/ and tools/ of the port, each through its
    main with its output under out_dir/studies): the sampling studies at a
    cut frame (STUDY_CUT, ground truths of 1024 spp, steps of 32), the
    device-time probes at 1104x1000 with few repetitions, scene_scale_bench
    at every object count on the bf16 chain with each count's K3 against
    its plain version (host noise, STUDY_COUNTS_CHECK), the figure tools and
    the Sobol table's generator, and ui_probe's five phases against a CLI
    subprocess.  Each in-process study zeroes the launch counters before and
    reads them after: K3 must have launched and no plain version run on the
    card.  Any study that raises or returns non-zero fails the run."""
    from ipu_path_trace_tpu_torch.core.records import make_worklist, to_device_batch
    from ipu_path_trace_tpu_torch.core.scene import grid_scene
    from ipu_path_trace_tpu_torch.models.nif import load_nif_assets
    from ipu_path_trace_tpu_torch.ops import megastep
    from ipu_path_trace_tpu_torch.probes import (adaptive_bench, adaptive_depth_check,
                                                 adaptive_knob_sweep, coherent_layout_probe,
                                                 denoise_bench, envskip_bench, fused_bench,
                                                 host_roundtrip_bench, megastep_split,
                                                 phase_bench, scene_scale_bench, sobol_bench,
                                                 ui_probe)
    from ipu_path_trace_tpu_torch.render import _sobol_dirs
    from ipu_path_trace_tpu_torch.render.params import RenderSettings
    from ipu_path_trace_tpu_torch.tools import (adaptive_compare, denoise_compare,
                                                gen_sobol_dirs, sobol_compare)

    t12 = time.monotonic()
    sdir = out_dir / "studies"
    res = {"seconds": {}, "launches": {}, "results": {}}
    gt = ["--gt-spp", "1024"]

    def finite(*xs) -> bool:
        return bool(np.isfinite(np.asarray(xs, dtype=np.float64)).all())

    def study(name, mod, args, out_name, check, k3=True):
        for f in counters:
            f.launches = 0
        for f in plains:
            f.cuda_runs = 0
        t0 = time.monotonic()
        rc = mod.main(["--out", str(sdir / name)] + args)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        got = [f.launches for f in counters]
        plain_cuda = [f.cuda_runs for f in plains]
        data = json.loads((sdir / name / out_name).read_text()) if out_name else {}
        ok = (rc == 0 and check(data) and not any(plain_cuda)
              and (got[2] > 0 if k3 else True))
        res["seconds"][name], res["launches"][name], res["results"][name] = secs, got, data
        phase(f"study {name}", ok, rc=rc, launches_trace_shade_megastep_apply=got,
              plain_runs_on_cuda=plain_cuda, seconds=f"{secs:.1f}")
        return data

    # Group 1: what the sampling features buy, at a cut frame.
    ab = study("adaptive_bench", adaptive_bench, STUDY_CUT + gt + ["--spp-step", "32"],
               "adaptive_bench.json",
               lambda d: finite(*d["sample_efficiency"], d["time_to_quality_speedup"])
               and len(d["adaptive"]) == 5 and d["final_counts"]["max"] > d["final_counts"]["min"])
    study("sobol_bench", sobol_bench,
          STUDY_CUT + gt + ["--spp-step", "32", "--rate-steps", "2"], "sobol_bench.json",
          lambda d: finite(*(x for v in d["sample_efficiency_vs_prng_uniform"].values()
                             for x in v), *d["rates_mpaths_300spp"].values())
          and d["hw_vs_host_consistency"]["pass"])
    study("denoise_bench", denoise_bench, STUDY_CUT + gt + ["--preview-spp", "8,32,128"],
          "denoise_bench.json",
          lambda d: all(finite(*(v for e in s["denoised"] for k, v in e.items() if "rmse" in k))
                        and len(s["denoised"]) == 3 for s in d["scenes"].values()))
    study("adaptive_depth_check", adaptive_depth_check,
          STUDY_CUT + ["--n", "2048", "--spp-step", "32", "--speedup",
                       str(max(1.0, ab.get("time_to_quality_speedup", 1.0)))],
          "adaptive_depth_check.json",
          lambda d: finite(d["depth_check"]["noise_ratio_a_over_u"])
          and isinstance(d["depth_check"]["holds"], bool))
    study("adaptive_knob_sweep", adaptive_knob_sweep,
          STUDY_CUT + gt + ["--spp-step", "32", "--steps", "4"], "adaptive_knob_sweep.json",
          lambda d: finite(*(r["sample_efficiency"] for r in d["knob_sweep"]["rows"]))
          and len(d["knob_sweep"]["rows"]) == len(adaptive_knob_sweep.KNOBS))

    # Group 2: where the device time goes, at 1104x1000 with few repetitions.
    full = ["--width", str(MAIN_W), "--height", str(MAIN_H)]
    study("fused_bench", fused_bench, full + ["--reps", "1"], "fused_bench.json",
          lambda d: finite(*d["ms_per_sample"].values()))
    study("phase_bench", phase_bench, full + ["--reps", "1"], "phase_bench.json",
          lambda d: finite(*d["ms_per_sample"].values())
          and min(d["ms_per_sample"]["trace"], d["ms_per_sample"]["env_shade"]) > 0)
    megastep.render_megastep.stub_launches = dict.fromkeys(megastep.STUBS, 0)
    study("megastep_split", megastep_split, full + ["--loop", "32", "--reps", "1"],
          "megastep_split.json",
          lambda d: set(d["ms_per_sample"]) == {"bf16", "int8", "tf32"}
          and finite(*(v for c in d["ms_per_sample"].values() for v in c.values())))
    res["stub_launches"] = dict(megastep.render_megastep.stub_launches)
    phase("study megastep_split ran every stub", all(
        v > 0 for v in res["stub_launches"].values()), stub_launches=res["stub_launches"])
    study("host_roundtrip_bench", host_roundtrip_bench,
          ["--size", f"{MAIN_W}x{MAIN_H}", "--steps", "8:3,300:1"], "host_roundtrip_bench.json",
          lambda d: finite(*(r["host_film_step_ms"] for r in d["rows"]),
                           *(r["device_ms"] for r in d["rows"])))
    study("coherent_layout_probe", coherent_layout_probe,
          full + ["--spp", "64", "--min-seconds", "0.3", "--samples", "1"],
          "coherent_layout_probe.json",
          lambda d: finite(d["coherent_vs_raster"], d["shuffled_vs_raster"]))
    study("envskip_bench", envskip_bench, full + ["--spp", "64", "--samples", "2", "--reps", "1"],
          "envskip_bench.json",
          lambda d: d["scenes"]["enclosed"]["dead_block_fraction"] == 1.0
          and finite(*(r["k3_ms_per_sample"] for r in d["scenes"].values())))
    study("scene_scale_bench", scene_scale_bench,
          full + ["--chains", "bf16", "--spp", "64", "--min-seconds", "0.3"],
          "scene_scale_bench.json",
          lambda d: [r["objects"] for r in d["rows"]] == list(scene_scale_bench.COUNTS)
          and finite(*(r["ms_per_sample"] for r in d["rows"])))
    # Each swept count's K3 against its plain version (bf16, host noise).
    bf16 = load_nif_assets(str(ROOT / ASSET), torch.bfloat16, dev)[0]
    w, h = STUDY_COUNTS_CHECK
    work = to_device_batch(make_worklist(w, h), dev)
    cols, rows = work.u.float(), work.v.float()
    gen = np.random.default_rng(12)
    noise = gen.uniform(0.0, 1.0, (2, 44, w * h)).astype(np.float32)
    noise[:, 0:2] = gen.normal(size=(2, 2, w * h))
    noise_t = torch.from_numpy(noise).to(dev)
    kw = dict(width=w, height=h, max_path_length=10)
    settings = RenderSettings.make(samples_per_step=2)
    for n in scene_scale_bench.COUNTS:
        scene = grid_scene(n - 1, device=dev)
        megastep_check(f"K3 bf16 host-noise on grid_scene, {n} objects",
                       megastep.render_megastep(scene, settings, bf16, cols, rows,
                                                noise=noise_t, **kw),
                       megastep.render_megastep_plain(scene, settings, bf16, cols, rows,
                                                      noise=noise_t, **kw), False)

    # The figures and the Sobol table.
    study("adaptive_compare", adaptive_compare, STUDY_CUT + ["--steps", "2", "--spp-step", "32"],
          None, lambda d: (sdir / "adaptive_compare" / "adaptive_compare.png").stat().st_size > 0)
    study("sobol_compare", sobol_compare, STUDY_CUT + ["--spp", "8"], None,
          lambda d: (sdir / "sobol_compare" / "sobol_compare.png").stat().st_size > 0)
    study("denoise_compare", denoise_compare, ["--size", "128", "--spp", "8"], None,
          lambda d: (sdir / "denoise_compare" / "denoise_compare.png").stat().st_size > 0,
          k3=False)
    phase("study gen_sobol_dirs", gen_sobol_dirs.directions() == _sobol_dirs.DIRS
          and gen_sobol_dirs.main(["--out", str(sdir / "gen_sobol_dirs")]) == 0)

    # Group 3: the UI on the card, through a CLI subprocess.
    study("ui_probe", ui_probe, ["--port", str(free_port()), "--size", "256", "--window", "3",
                                 "--exposure-wait", "1"], "ui_probe.json",
          lambda d: all(p["ok"] for p in d["phases"]) and d["steps"]["steps"] > 0, k3=False)
    res["seconds"]["total"] = time.monotonic() - t12
    print(f"[timing] phase 12 (the studies): " + ", ".join(
        f"{k} {v:.1f} s" for k, v in res["seconds"].items()) + f" ({smi})", flush=True)
    return res


def main() -> None:
    # 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this check runs on a GPU")
    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    print(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    print(smi, flush=True)

    from ipu_path_trace_tpu_torch.core.records import to_device_batch
    from ipu_path_trace_tpu_torch.core.scene import default_scene
    from ipu_path_trace_tpu_torch.core.scenefile import scene_from_dict
    from ipu_path_trace_tpu_torch.core.vecmath import Vec3
    from ipu_path_trace_tpu_torch.models.envlight import NifEnv
    from ipu_path_trace_tpu_torch.models.nif import load_nif_assets
    from ipu_path_trace_tpu_torch.models.quant import quantize_nif
    from ipu_path_trace_tpu_torch.ops import _lib, megastep, nif, trace
    from ipu_path_trace_tpu_torch.probes.host_pipeline import profile_report
    from ipu_path_trace_tpu_torch.render.adaptive import (adaptive_caps, adaptive_render_step,
                                                          compute_budgets)
    from ipu_path_trace_tpu_torch.render.params import RenderSettings, StaticConfig
    from ipu_path_trace_tpu_torch.render.wavefront import render_step
    from ipu_path_trace_tpu_torch.runtime import cli
    from ipu_path_trace_tpu_torch.runtime.app import parse_env_assets
    from ipu_path_trace_tpu_torch.runtime.worklist import coherent_order, create_tracing_jobs

    # 2. build -------------------------------------------------------------
    t0 = time.monotonic()
    lib_path = _lib.build()
    _lib.library()
    build_s = time.monotonic() - t0
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    phase("build", True, seconds=f"{build_s:.1f}", library=lib_path.name)
    for ln in ptxas:
        print(f"  ptxas: {ln}")

    scene = default_scene(dev)
    model, meta, weights = load_nif_assets(str(ROOT / ASSET), torch.bfloat16, dev)
    model32 = load_nif_assets(str(ROOT / ASSET), torch.float32, dev)[0]  # the tf32 chain
    mixed, mixed_meta, mixed_weights = load_nif_assets(str(ROOT / MIXED_ASSET), torch.bfloat16,
                                                       dev)
    q8 = parse_env_assets(str(ROOT / INT8_ASSET), dev, "int8")[0].model  # the QAT grids
    q8_canonical = quantize_nif(weights, meta, device=dev)  # lattice-calibrated
    q8_mixed = quantize_nif(mixed_weights, mixed_meta, device=dev)
    enclosed = scene_from_dict(ENCLOSED_SCENE, dev)
    gen = np.random.default_rng(2024)

    def grid(w, h, on=None):
        wl = coherent_order(create_tracing_jobs(w, h), on or scene, w, h, 90.0)
        work = to_device_batch(wl, dev)
        return work.u.float(), work.v.float()

    def sobol_ctx(cols, rows, width):
        """(pixel id, per-lane base from the numpy seed, key) of Sobol mode."""
        pid = rows.to(torch.int32) * width + cols.to(torch.int32)
        base = torch.from_numpy(gen.integers(0, 4096, cols.shape[0]).astype(np.int32)).to(dev)
        return pid, base, SOBOL_KEY

    def random_budgets(n, most):
        groups = -(-n // megastep.BUDGET_BLOCK)
        return torch.from_numpy(gen.integers(1, most + 1, groups).astype(np.int32)).to(dev)

    def mode_checks(tag, cols, rows, kw, settings, seed, noise):
        """Phase 5b's checks at one shape: K1 Sobol, then K3's modes with
        both chains (host noise covers the budgets), then K3 on the enclosed
        scene."""
        sob = sobol_ctx(cols, rows, kw["width"])
        for dims in (SOBOL_DIMS, 4 + 4 * kw["max_path_length"]):
            err["trace_sobol"] = max(err.get("trace_sobol", 0.0), trace_exact(
                f"K1 sobol {dims} dims {tag}",
                trace.trace_sample(scene, settings, cols, rows, seed, sample_index=3, sobol=sob,
                                   sobol_dims=dims, **kw),
                trace.trace_sample_plain(scene, settings, cols, rows, seed, sample_index=3,
                                         sobol=sob, sobol_dims=dims, **kw)))
        budgets = random_budgets(cols.shape[0], noise.shape[0])
        sobol = dict(sobol=sob, sobol_dims=SOBOL_DIMS)
        stats = dict(budgets=budgets, with_stats=True)
        modes = [("sobol", "sobol", dict(seed=seed, **sobol)),
                 ("budgets+stats", "budgets_stats", dict(seed=seed, **stats)),
                 ("budgets+stats host-noise", "budgets_stats", dict(noise=noise, **stats)),
                 ("sobol+budgets+stats", "sobol_budgets_stats",
                  dict(seed=seed, **sobol, **stats))]
        ecols, erows = grid(kw["width"], kw["height"], enclosed)
        for m in (model, q8):
            int8 = is_int8(m)
            prefix, label8 = ("megastep_int8", "int8 ") if int8 else ("megastep", "")
            for label, key, args in modes:
                key = f"{prefix}_{key}"
                err[key] = max(err.get(key, 0.0), mode_check(
                    f"K3 {label8}{label} {tag}",
                    megastep.render_megastep(scene, settings, m, cols, rows, **args, **kw),
                    megastep.render_megastep_plain(scene, settings, m, cols, rows, **args, **kw),
                    int8))
            got = megastep.render_megastep(enclosed, settings, m, ecols, erows, seed,
                                           with_stats=True, **kw)
            key = f"{prefix}_enclosed"
            err[key] = max(err.get(key, 0.0), mode_check(
                f"K3 {label8}enclosed {tag}", got,
                megastep.render_megastep_plain(enclosed, settings, m, ecols, erows, seed,
                                               with_stats=True, **kw),
                int8))
            phase(f"K3 {label8}enclosed {tag} lit by the trace",
                  float((got.radiance.stack() > 0.0).float().mean()) > 0.99)

    def ragged_checks(cols, rows, kw, settings, seed, noise):
        """K3, bf16 and int8, at a ragged n whose last CUDA block has one
        live 128-ray tile, with budgets of 0, 1 and 8 in one launch and the
        statistics (Philox and host noise), and on the enclosed scene."""
        n = RAGGED_K3
        rc, rr = cols[:n].contiguous(), rows[:n].contiguous()
        budgets = torch.from_numpy(gen.choice([0, 1, 8], -(-n // megastep.BUDGET_BLOCK))
                                   .astype(np.int32)).to(dev)
        rnoise = noise[:, :, :n].contiguous()
        common = dict(budgets=budgets, with_stats=True)
        ecols, erows = grid(kw["width"], kw["height"], enclosed)
        ec, er = ecols[:n].contiguous(), erows[:n].contiguous()
        for m in (model, q8):
            int8 = is_int8(m)
            key, label8 = ("megastep_int8_ragged", "int8 ") if int8 else ("megastep_ragged", "")
            for label, args in (("philox", dict(seed=seed, **common)),
                                ("host-noise", dict(noise=rnoise, **common))):
                err[key] = max(err.get(key, 0.0), mode_check(
                    f"K3 {label8}ragged {n} {label} budgets 0/1/8+stats",
                    megastep.render_megastep(scene, settings, m, rc, rr, **args, **kw),
                    megastep.render_megastep_plain(scene, settings, m, rc, rr, **args, **kw),
                    int8))
            got, ref = (fn(enclosed, settings, m, ec, er, seed, **common, **kw)
                        for fn in (megastep.render_megastep, megastep.render_megastep_plain))
            err[key] = max(err[key], mode_check(
                f"K3 {label8}ragged {n} enclosed budgets 0/1/8+stats", got, ref, int8))

    def stub_checks(tag, cols, rows, kw, settings, seed):
        """Phase 5c: K3's stubs in the three chains and both hardware RNG
        modes."""
        sob = sobol_ctx(cols, rows, kw["width"])
        for m in (model, q8, model32):
            label8 = "int8 " if is_int8(m) else "tf32 " if m.dtype == torch.float32 else ""
            for rng, extra in (("philox", {}), ("sobol", dict(sobol=sob, sobol_dims=SOBOL_DIMS))):
                for stub in megastep.STUBS:
                    got = megastep.render_megastep(scene, settings, m, cols, rows, seed, stub=stub,
                                                   **extra, **kw)
                    ref = megastep.render_megastep_plain(scene, settings, m, cols, rows, seed,
                                                         stub=stub, **extra, **kw)
                    a, b = got.radiance.stack(), ref.radiance.stack()
                    plen_ok = torch.equal(got.path_len, ref.path_len)
                    rel = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                    if stub == "nif":
                        ok = plen_ok and rel <= 1e-6 and bool(torch.isfinite(a).all())
                    else:
                        full = settings.samples_per_step * kw["max_path_length"]
                        ok = (plen_ok and torch.equal(a, b) and not a.any()
                              and bool((got.path_len == full).all()))
                    key = f"megastep_stub_{stub}"
                    err[key] = max(err.get(key, 0.0), float((a - b).abs().max()))
                    phase(f"K3 {label8}stub '{stub}' {rng} {tag}", ok, path_len_equal=plen_ok,
                          max_rel=f"{rel:.2e}", max_abs_err=f"{float((a - b).abs().max()):.3e}")

    # 3. K1 ------------------------------------------------------------------
    L = 10
    cols, rows = grid(256, 256)
    p = cols.shape[0]
    noise = gen.uniform(0.0, 1.0, (4 + 4 * L, p)).astype(np.float32)
    noise[0:2] = gen.normal(size=(2, p))
    noise_t = torch.from_numpy(noise).to(dev)
    settings = RenderSettings.make(samples_per_step=4)
    kw = dict(width=256, height=256, max_path_length=L)
    k1_err = trace_check(
        "K1 host-noise",
        trace.trace_sample(scene, settings, cols, rows, noise=noise_t, **kw),
        trace.trace_sample_plain(scene, settings, cols, rows, noise=noise_t, **kw))
    k1_err = max(k1_err, trace_check(
        "K1 philox",
        trace.trace_sample(scene, settings, cols, rows, (11, 22), sample_index=3, **kw),
        trace.trace_sample_plain(scene, settings, cols, rows, (11, 22), sample_index=3, **kw)))

    # 4. K2 ------------------------------------------------------------------
    n2 = 65_536
    d = gen.normal(size=(3, n2)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    escaped = gen.uniform(size=n2) < 0.8
    d[:, ~escaped] = 0.0
    w = gen.uniform(0.0, 2.0, (3, n2)).astype(np.float32)
    w[:, ~escaped] = 0.0
    esc_dir = Vec3.unstack(torch.from_numpy(d).to(dev))
    esc_w = Vec3.unstack(torch.from_numpy(w).to(dev))
    err = {}
    err["env_shade"] = max(shade_check("K2", model, esc_dir, esc_w, 0.7),
                           shade_check("K2 mixed-width", mixed, esc_dir, esc_w, 0.7))
    err["env_shade_int8"] = max(shade_check("K2 int8", q8, esc_dir, esc_w, 0.7),
                                shade_check("K2 int8 mixed-width", q8_mixed, esc_dir, esc_w, 0.7))

    # 4b. K4 -----------------------------------------------------------------
    u, v = (torch.from_numpy(gen.uniform(0.0, 1.0, (2, n2)).astype(np.float32)).to(dev))
    err["nif_apply"] = max(apply_check("K4 bf16", model, u, v),
                           apply_check("K4 bf16 mixed-width", mixed, u, v))
    err["nif_apply_int8"] = max(apply_check("K4 int8", q8, u, v),
                                apply_check("K4 int8 canonical PTQ", q8_canonical, u, v),
                                apply_check("K4 int8 mixed-width", q8_mixed, u, v))
    # The chains' 128-ray tiles with a ragged last one (37 lanes).
    ragged = n2 + 37
    rd = gen.normal(size=(3, ragged)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    r_escaped = gen.uniform(size=ragged) < 0.8
    rd[:, ~r_escaped] = 0.0
    r_weight = gen.uniform(0.0, 2.0, (3, ragged)).astype(np.float32)
    r_weight[:, ~r_escaped] = 0.0
    rdir = Vec3.unstack(torch.from_numpy(rd).to(dev))
    rw = Vec3.unstack(torch.from_numpy(r_weight).to(dev))
    ru, rv = (torch.from_numpy(gen.uniform(0.0, 1.0, (2, ragged)).astype(np.float32)).to(dev))
    for m, tag in ((model, "bf16"), (mixed, "bf16 mixed-width"), (q8, "int8"),
                   (q8_canonical, "int8 canonical PTQ"), (q8_mixed, "int8 mixed-width")):
        suffix = "_int8" if is_int8(m) else ""
        err["env_shade" + suffix] = max(err["env_shade" + suffix], shade_check(
            f"K2 {tag} ragged {ragged}", m, rdir, rw, 0.7))
        err["nif_apply" + suffix] = max(err["nif_apply" + suffix], apply_check(
            f"K4 {tag} ragged {ragged}", m, ru, rv))

    # 4c. the wgmma kernels (K2, K3, K4 and K8's): SASS and ptxas -------
    functions = sass_functions(lib_path)
    build_log = lib_path.with_suffix(".log").read_text().splitlines()
    wg_sass = wg_instantiations(functions, build_log)
    for key, v in wg_sass.items():
        print(f"[ptxas] {key} (wgmma): {' | '.join(v['ptxas'])}", flush=True)
    for ln in build_log:
        if "wgmma" in ln.lower():
            print(f"[ptxas] {ln.strip()}", flush=True)
    for kernel in ("K2", "K4"):
        for chain in ("bf16", "int8", "tf32"):
            v = wg_sass.get(f"{kernel} {chain}")
            phase(f"SASS {kernel} {chain}", functions is not None and v is not None
                  and holds_its_chain(v), cuobjdump=functions is not None,
                  **{op: (v or {}).get(op) for op in MMA_OPS + ("HGMMA_RZ", "HGMMA_TF32")})
    built = [f"{r} production{rec}" for r in RNG_NAMES.values()
             for rec in ("", " recording")] + [
        f"{r} {st}" for r in ("philox", "sobol") for st in list(STUB_NAMES.values())[1:]]
    for chain in ("bf16", "int8", "tf32"):
        k3 = {k: v for k, v in wg_sass.items() if k.startswith(f"K3 {chain} ")}
        own = OWN_MMA[chain]
        phase(f"SASS megastep {chain}", functions is not None
              and sorted(k3) == sorted(f"K3 {chain} {b}" for b in built)
              and all(holds_its_chain(v) for v in k3.values())
              and not any(OLD_K3.search(name) for name, _ in functions),
              cuobjdump=functions is not None,
              **{k[4 + len(chain):].replace(" ", "_"): f"{v[own]}/{v['HMMA'] + v['IMMA']}"
                 for k, v in k3.items()})
    spills = {k: v["spill_bytes"] for k, v in wg_sass.items() if k[:2] in ("K2", "K3", "K4")}
    phase("ptxas K2 K3 K4 no spills", len(spills) == 6 + 3 * len(built)
          and all(v["ptxas"] for v in wg_sass.values()) and not any(spills.values()),
          spill_bytes=spills)

    # 4d. the f32 chain on TF32 wgmma: K2, K3, K4 under --partials-type float
    from ipu_path_trace_tpu_torch.probes import tf32_chain

    t4d = time.monotonic()
    tf32_res = tf32_chain.run(dev)
    for c in tf32_res["checks"]:
        phase(c["name"], c["ok"], **{k: f"{v:.3e}" if isinstance(v, float) else v
                                     for k, v in c.items() if k not in ("name", "ok")})
    for key, tag in (("env_shade_tf32", "K2 "), ("megastep_tf32", "K3 "),
                     ("nif_apply_tf32", "K4 ")):
        err[key] = max(c["max_abs_err"] for c in tf32_res["checks"]
                       if c["name"].startswith(tag) and "max_abs_err" in c)
    print(f"[timing] phase 4d (the tf32 chain): {time.monotonic() - t4d:.1f} s; "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in tf32_res["times_ms"].items())
          + f" ({smi})", flush=True)

    # 5. K3 ------------------------------------------------------------------
    s3 = 4
    noise3 = gen.uniform(0.0, 1.0, (s3, 4 + 4 * L, p)).astype(np.float32)
    noise3[:, 0:2] = gen.normal(size=(s3, 2, p))
    noise3_t = torch.from_numpy(noise3).to(dev)
    for name, m in (("megastep", model), ("megastep_int8", q8)):
        err[name] = megastep_check(
            f"K3 {'int8 ' if is_int8(m) else ''}host-noise",
            megastep.render_megastep(scene, settings, m, cols, rows, noise=noise3_t, **kw),
            megastep.render_megastep_plain(scene, settings, m, cols, rows, noise=noise3_t,
                                           **kw), is_int8(m))

    # 5b. the Sobol and budget/statistics modes, the enclosed scene ---------
    mode_checks("256x256", cols, rows, kw, settings, (13, 14), noise3_t)
    ragged_checks(cols, rows, kw, settings, (13, 14), noise3_t)

    # 5c. K3's measurement stubs --------------------------------------------
    stub_checks("256x256", cols, rows, kw, settings, (15, 16))
    k3_256 = (cols, rows, settings, kw)  # phase 6f's K3 check on new weights

    # 6. main path through the CLI ------------------------------------------
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    enclosed_json = out_dir / "enclosed.json"
    enclosed_json.write_text(json.dumps(ENCLOSED_SCENE))
    counters = (trace.trace_sample, nif.nif_env_shade, megastep.render_megastep,
                nif.nif_apply_t)
    plains = (trace.trace_sample_plain, nif.nif_env_shade_plain,
              megastep.render_megastep_plain, nif.nif_apply_t_plain)
    steps = MAIN_SPP // MAIN_SPS
    bake_chunks = -(-meta.image_shape[0] // BAKE_ROWS)
    int8_flags = ["--nif-precision", "int8"]
    adaptive = ["--device-film", "--adaptive", "--adaptive-min", str(ADAPTIVE_MIN)]
    sobol_flags = ["--sampler", "sobol"]
    f32_flags = ["--partials-type", "float"]
    fused_want = [0, 0, steps, 0]  # a fused NIF run launches K3 alone
    # (name, asset, flags, fused, launches of trace, env shade, megastep, nif
    # apply)
    runs = [
        ("main fused", ASSET, [], True, fused_want),
        ("main unfused", ASSET, [], False, [MAIN_SPP, MAIN_SPP, 0, 0]),
        ("main int8 fused", INT8_ASSET, int8_flags, True, fused_want),
        ("main int8 unfused", INT8_ASSET, int8_flags, False, [MAIN_SPP, MAIN_SPP, 0, 0]),
        ("main baked", ASSET, ["--nif-mode", "baked"], True, [MAIN_SPP, 0, 0, bake_chunks]),
        ("main baked int8", INT8_ASSET, int8_flags + ["--nif-mode", "baked"], True,
         [MAIN_SPP, 0, 0, bake_chunks]),
        ("device film", ASSET, ["--device-film"], True, fused_want),
        # Fetched and saved at the last step only: what the device film saves.
        ("device film save-interval 2", ASSET, ["--device-film", "--save-interval", "2"], True,
         fused_want),
        ("device film adaptive", ASSET, adaptive, True, fused_want),
        ("sobol fused", ASSET, sobol_flags, True, fused_want),
        ("sobol unfused", ASSET, sobol_flags, False, [MAIN_SPP, MAIN_SPP, 0, 0]),
        ("enclosed scene", ASSET, ["--scene", str(enclosed_json)], True, fused_want),
        ("int8 device film adaptive sobol", INT8_ASSET, int8_flags + adaptive + sobol_flags,
         True, fused_want),
        # The reference's shuffle and per-step re-deal (host task), fused.
        ("load balancing", ASSET, ["--enable-load-balancing"], True, fused_want),
        # --partials-type float: the f32 chain on tf32 wgmma in K3, K2 and K4.
        ("f32 fused", ASSET, f32_flags, True, fused_want),
        ("f32 unfused", ASSET, f32_flags, False, [MAIN_SPP, MAIN_SPP, 0, 0]),
        ("f32 baked", ASSET, f32_flags + ["--nif-mode", "baked"], True,
         [MAIN_SPP, 0, 0, bake_chunks]),
    ]
    lum, launches, frames, wall, step_s, save_s, wait_s = {}, {}, {}, {}, {}, {}, {}
    routes = {}  # each CLI run's native and plain host-runtime calls
    # The app's per-step, per-save and bake seconds, on stdout (cli.main's
    # own logging set-up then keeps this handler).
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="  app: %(asctime)s %(message)s")
    app_log = LogLines()
    logging.getLogger().addHandler(app_log)
    for name, asset, flags, fused, want in runs:
        png = out_dir / f"{name.replace(' ', '_')}.png"
        argv = ["-w", str(MAIN_W), "-H", str(MAIN_H), "-s", str(MAIN_SPP),
                "--samples-per-step", str(MAIN_SPS), "--assets", str(ROOT / asset),
                "-o", str(png), *flags]
        app_log.lines.clear()
        for f in counters:
            f.launches = 0
        for f in plains:
            f.cuda_runs = 0
        zero_host_calls()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rc = cli.main(argv, use_fused_step=fused)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        routes[name] = host_calls()
        got = [f.launches for f in counters]
        plain_cuda = [f.cuda_runs for f in plains]
        launches[name] = dict(zip(("trace", "env_shade", "megastep", "nif_apply"), got))
        mean, se, hdr = frame_luminance(png.with_suffix(".exr"))
        lum[name] = (mean, se)
        frames[name] = hdr
        wall[name] = secs
        step_s[name] = app_log.seconds("Completed render step")
        save_s[name] = app_log.seconds("Saved images")
        wait_s[name] = app_log.waits()
        phase(name, rc == 0 and got == want and not any(plain_cuda)
              and bool(np.isfinite(hdr).all()) and hdr.shape == (MAIN_H, MAIN_W, 3),
              launches_trace_shade_megastep_apply=got, plain_runs_on_cuda=plain_cuda,
              mean_luminance=f"{mean:.6f}", mc_se=f"{se:.2e}",
              mpaths_per_s_incl_setup=f"{MAIN_W * MAIN_H * MAIN_SPP / secs / 1e6:.2f}",
              wall_s=f"{secs:.2f}")

    def gap(a, b):
        return abs(lum[a][0] - lum[b][0]), 5.0 * math.hypot(lum[a][1], lum[b][1])

    for a, b in (("main fused", "main unfused"), ("main int8 fused", "main int8 unfused"),
                 ("sobol fused", "sobol unfused"), ("f32 fused", "f32 unfused")):
        g, bound = gap(a, b)
        phase(f"{a} vs unfused", g <= bound, luminance_gap=f"{g:.3e}", bound_5se=f"{bound:.3e}")
    g, bound = gap("load balancing", "main fused")
    phase("load balancing vs main fused", g <= bound, luminance_gap=f"{g:.3e}",
          bound_5se=f"{bound:.3e}")
    # Same seeds, same samples: the film rebuilt from the device's running
    # sums is the host film's step-wise sum, up to the order of f32 adds.
    for name in ("device film", "device film save-interval 2"):
        rel = float(np.max(np.abs(frames[name] - frames["main fused"])
                           / (np.abs(frames["main fused"]) + 1e-6)))
        phase(f"{name} = host film", rel < 1e-5, max_rel=f"{rel:.2e}")
    for a, b in (("main int8 fused", "main fused"), ("main baked", "main fused"),
                 ("main baked int8", "main int8 fused"), ("device film adaptive", "main fused"),
                 ("sobol fused", "main fused"),
                 ("int8 device film adaptive sobol", "main int8 fused"),
                 ("f32 fused", "main fused"), ("f32 baked", "f32 fused")):
        g, bound = gap(a, b)
        print(f"[gap] {a} vs {b}: mean luminance {lum[a][0]:.6f} vs {lum[b][0]:.6f}, "
              f"gap {g:.3e} ({g / lum[b][0]:.2%}), 5 SE {bound:.3e} (information only)",
              flush=True)
    for name in ("main fused", "device film", "device film save-interval 2",
                 "device film adaptive", "load balancing"):
        print(f"[timing] film: {name}: wall {wall[name]:.3f} s, steps {step_s[name]} s, "
              f"saves {save_s[name]} s, waits for the host task {wait_s[name]} s ({smi})",
              flush=True)

    # 6a. the host pipeline: the serial loop, SIGTERM, resume ---------------
    main_argv = ["-w", str(MAIN_W), "-H", str(MAIN_H), "-s", str(MAIN_SPP),
                 "--samples-per-step", str(MAIN_SPS), "--assets", str(ROOT / ASSET)]
    serial_png = out_dir / "serial_loop.png"
    serial_loop(cli.parse_config(main_argv + ["-o", str(serial_png)]))
    same = (serial_png.with_suffix(".exr").read_bytes()
            == (out_dir / "main_fused.exr").read_bytes())
    phase("pipelined host film = serial loop", same, exr_bytes_equal=same)
    for name, asset, flags, full in (
            ("resume host film", ASSET, [], "main fused"),
            ("resume device film adaptive", ASSET, adaptive, "device film adaptive")):
        ck = out_dir / f"{name.replace(' ', '_')}.npz"
        ck.unlink(missing_ok=True)
        halves = []
        for half, extra in (("a", ["--checkpoint", str(ck)]), ("b", ["--resume", str(ck)])):
            png = out_dir / f"{name.replace(' ', '_')}_{half}.png"
            stopper = StopAfter(1) if half == "a" else None
            argv = main_argv[:-1] + [str(ROOT / asset), "-o", str(png), *flags, *extra]
            app_log.lines.clear()
            for f in counters:
                f.launches = 0
            zero_host_calls()
            if stopper:
                logging.getLogger().addHandler(stopper)
            try:
                rc = cli.main(argv)
            finally:
                if stopper:
                    logging.getLogger().removeHandler(stopper)
            routes[f"{name} {half}"] = host_calls()
            halves.append(dict(rc=rc, png=png, megastep=megastep.render_megastep.launches,
                               lines=list(app_log.lines)))
        a, b = halves
        step = load_checkpoint_step(ck) if ck.exists() else None
        if name == "resume host film":
            text = "\n".join(a["lines"])
            phase("SIGTERM mid-render", a["rc"] == 0 and "Received signal 15" in text
                  and "Stop requested (signal); exiting after step 1" in text and step == 1
                  and a["png"].exists() and a["png"].with_suffix(".exr").exists(),
                  rc=a["rc"], checkpoint_step=step, megastep_launches=a["megastep"])
        same = (b["png"].with_suffix(".exr").read_bytes()
                == (out_dir / f"{full.replace(' ', '_')}.exr").read_bytes())
        phase(f"{name} bitwise", a["rc"] == 0 and b["rc"] == 0 and same
              and a["megastep"] == 1 and b["megastep"] == 1,
              stopped_after=step, exr_bytes_equal=same, megastep_launches=[a["megastep"],
                                                                           b["megastep"]])

    # 6b. --device-timing, --profile-dir and --metrics-file -----------------
    from ipu_path_trace_tpu_torch.utils import devtime

    prof_dir, metrics_file = out_dir / "profile", out_dir / "metrics.jsonl"
    shutil.rmtree(prof_dir, ignore_errors=True)
    metrics_file.unlink(missing_ok=True)
    app_log.lines.clear()
    for f in counters:
        f.launches = 0
    megastep.render_megastep.stub_launches = dict.fromkeys(megastep.STUBS, 0)
    zero_host_calls()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rc = cli.main(["-w", str(MAIN_W), "-H", str(MAIN_H), "-s", str(MAIN_SPP),
                   "--samples-per-step", str(MAIN_SPS), "--assets", str(ROOT / ASSET),
                   "-o", str(out_dir / "device_timing.png"), "--device-timing",
                   "--profile-dir", str(prof_dir), "--metrics-file", str(metrics_file)])
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    routes["device timing"] = host_calls()
    splits = app_log.phase_splits()
    got = [f.launches for f in counters]
    stub_got = dict(megastep.render_megastep.stub_launches)
    timed = 3  # measure_phases: a warm-up and reps=2 launches per variant
    launches["device timing"] = {**dict(zip(("trace", "env_shade", "megastep", "nif_apply"), got)),
                                 **{f"megastep_stub_{k}": v for k, v in stub_got.items()}}
    split = splits[-1] if splits else {}
    parts = [split.get(k, 0.0) for k in ("env_ms", "trace_ms", "overhead_ms")]
    # Four numbers logged to 1e-3 ms each: the parts sum to the step within 2e-3.
    split_ok = (len(splits) == 1 and all(x > 0 for x in parts)
                and abs(sum(parts) - split.get("step_ms", 0.0)) <= 2e-3)
    print(f"[timing] device phase split [{split.get('device')}] ({smi}): "
          f"{json.dumps(split)}", flush=True)
    phase("device timing split", rc == 0 and split_ok, **{k: f"{v:.4f}" for k, v in split.items()
                                                         if k.endswith("_ms")})
    # The split runs the 'nif' stub and the skeleton ('both'), as the reference.
    phase("device timing launches", got == [0, 0, steps + timed, 0]
          and stub_got == {"nif": timed, "trace": 0, "both": timed},
          launches_trace_shade_megastep_apply=got, stub_launches=stub_got)
    lines = [json.loads(ln) for ln in metrics_file.read_text().splitlines()]
    summary = lines[-1] if lines else {}
    phase("metrics file", [ln.get("step") for ln in lines[:-1]] == list(range(1, steps + 1))
          and summary.get("event") == "summary" and summary.get("total_spp") == MAIN_SPP,
          lines=len(lines), summary=summary)
    prof = profile_report(prof_dir / "trace.json")
    spans_ok = all(f"tpu_path_tracer/{n}" in prof["span_names"]
                   for n in ("ipu_render", "accumulate_framebuffers", "save_images"))
    phase("profiler trace", spans_ok, spans=prof["span_names"], wall_s=f"{secs:.2f}")
    if prof["kernel_events"]:
        print(f"[profile] {prof['kernel_events']} device kernel events; device busy share of "
              f"the {prof['window_ms']:.1f} ms render window: {prof['busy_share']:.4f} "
              f"({smi})", flush=True)
        for name, kv in list(prof["kernels_by_name"].items())[:8]:
            print(f"[profile]   {kv['count']:4d} x {kv['us'] / kv['count']:10.1f} us  {name[:90]}")
    else:
        print("[profile] the trace holds no device kernel events (CUPTI gave none): the busy "
              "share is not measured", flush=True)

    # 6b'. --device-timing with --partials-type float: the stubs on the
    # f32 chain's tile (the 'nif' stub keeps the weights' type, as the
    # reference's _stub_nif_layer).
    app_log.lines.clear()
    for f in counters:
        f.launches = 0
    megastep.render_megastep.stub_launches = dict.fromkeys(megastep.STUBS, 0)
    for f in plains:
        f.cuda_runs = 0
    zero_host_calls()
    rc = cli.main(["-w", str(MAIN_W), "-H", str(MAIN_H), "-s", str(MAIN_SPP),
                   "--samples-per-step", str(MAIN_SPS), "--assets", str(ROOT / ASSET),
                   "-o", str(out_dir / "device_timing_f32.png"), "--device-timing", *f32_flags])
    torch.cuda.synchronize()
    routes["f32 device timing"] = host_calls()
    got = [f.launches for f in counters]
    stub_got = dict(megastep.render_megastep.stub_launches)
    plain_cuda = [f.cuda_runs for f in plains]
    launches["f32 device timing"] = {
        **dict(zip(("trace", "env_shade", "megastep", "nif_apply"), got)),
        **{f"megastep_stub_{k}": v for k, v in stub_got.items()}}
    split32 = (app_log.phase_splits() or [{}])[-1]
    parts = [split32.get(k, 0.0) for k in ("env_ms", "trace_ms", "overhead_ms")]
    phase("f32 device timing", rc == 0 and got == [0, 0, steps + timed, 0]
          and stub_got == {"nif": timed, "trace": 0, "both": timed} and not any(plain_cuda)
          and all(x > 0 for x in parts)
          and abs(sum(parts) - split32.get("step_ms", 0.0)) <= 2e-3,
          launches_trace_shade_megastep_apply=got, stub_launches=stub_got,
          plain_runs_on_cuda=plain_cuda, **{k: f"{v:.4f}" for k, v in split32.items()
                                             if k.endswith("_ms")})

    # 6c. the canonical 300-spp step: 1200 spp in 4 steps, saving each -----
    prof_dir, metrics_file = out_dir / "profile_300", out_dir / "metrics_300.jsonl"
    shutil.rmtree(prof_dir, ignore_errors=True)
    metrics_file.unlink(missing_ok=True)
    app_log.lines.clear()
    for f in counters:
        f.launches = 0
    zero_host_calls()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rc = cli.main(["-w", str(MAIN_W), "-H", str(MAIN_H), "-s", str(CANON_SPP),
                   "--samples-per-step", str(CANON_SPS), "--save-interval", "1",
                   "--assets", str(ROOT / ASSET), "-o", str(out_dir / "canonical.png"),
                   "--profile-dir", str(prof_dir), "--metrics-file", str(metrics_file)])
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    routes["canonical 300 spp"] = host_calls()
    canon_steps = CANON_SPP // CANON_SPS
    got = [f.launches for f in counters]
    lines = [json.loads(ln) for ln in metrics_file.read_text().splitlines()]
    canon_prof = profile_report(prof_dir / "trace.json")
    canonical = {"wall_s": secs, "render_s": lines[-1].get("elapsed_seconds") if lines else None,
                 "step_s": app_log.seconds("Completed render step"),
                 "save_s": app_log.seconds("Saved images"), "wait_s": app_log.waits(),
                 "busy_share": canon_prof["busy_share"], "window_ms": canon_prof.get("window_ms"),
                 "spans": canon_prof["span_names"]}
    print(f"[timing] canonical {CANON_SPP} spp in {canon_steps} steps of {CANON_SPS}, saving "
          f"each ({smi}): wall {secs:.3f} s, render loop {canonical['render_s']} s, steps "
          f"{canonical['step_s']} s, saves {canonical['save_s']} s, waits for the host task "
          f"{canonical['wait_s']} s, device busy share {canonical['busy_share']} of the "
          f"{canonical['window_ms']} ms render window", flush=True)
    spans_ok = all(f"tpu_path_tracer/{n}" in canon_prof["span_names"] for n in (
        "ipu_render", "wait_for_host", "accumulate_framebuffers", "clear_accumulators",
        "save_images"))
    phase("canonical 300-spp run", rc == 0 and got == [0, 0, canon_steps, 0]
          and len(lines) == canon_steps + 1 and spans_ok and canon_prof["busy_share"] is not None,
          launches_trace_shade_megastep_apply=got, host_thread_spans=spans_ok)

    # Every CLI run above took the native host runtime and no plain version.
    bad = {}
    for name, calls in routes.items():
        film_calls = calls["accumulate"] + calls["accumulate_soa"]
        lb = name == "load balancing"
        ok = (film_calls > 0 and calls["tonemap"] > 0 and not any(
            calls[k] for k in ("accumulate_plain", "tone_map_plain", "deal_order",
                               "clear_and_sum_plain"))
              and (calls["load_balance"] > 0) == lb)
        if "device film" not in name:
            ok = ok and calls["clear_and_sum_pathlengths"] > 0
        if not ok:
            bad[name] = calls
    phase("native host route in every CLI run", not bad, runs=len(routes), wrong=bad,
          load_balancing=routes["load balancing"])

    # 6e. --compile-only, the --save-exe / --load-exe round trip, the turntable
    import contextlib
    import io

    main_argv = ["-w", str(MAIN_W), "-H", str(MAIN_H), "-s", str(MAIN_SPP),
                 "--samples-per-step", str(MAIN_SPS), "--assets", str(ROOT / ASSET)]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main([*main_argv, "-o", str(out_dir / "never.png"), "--compile-only"])
    phase("--compile-only", rc == 0 and printed.getvalue().strip() == str(lib_path)
          and not (out_dir / "never.png").exists(), rc=rc, printed=printed.getvalue().strip())
    exe = out_dir / "exe" / "tracer"
    shutil.rmtree(exe.parent, ignore_errors=True)
    with contextlib.redirect_stdout(io.StringIO()):
        rc_save = cli.main([*main_argv, "-o", str(out_dir / "never.png"), "--compile-only",
                            "--save-exe", str(exe)])
    manifest = json.loads(exe.with_suffix(".json").read_text()) if rc_save == 0 else {}
    # A fresh process loads the saved library (this one has the build loaded).
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-m", "ipu_path_trace_tpu_torch.runtime.cli",
                          *main_argv, "-o", str(out_dir / "load_exe.png"), "--load-exe",
                          str(exe)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    load_s = time.monotonic() - t0
    same = res.returncode == 0 and (out_dir / "load_exe.exr").read_bytes() == (
        out_dir / "main_fused.exr").read_bytes()
    phase("--save-exe / --load-exe round trip", rc_save == 0 and same
          and manifest.get("digest") == lib_path.stem.rsplit("_", 1)[1]
          and manifest.get("gpu") == torch.cuda.get_device_name(0)
          and exe.with_suffix(".so").read_bytes() == lib_path.read_bytes(),
          rc=(rc_save, res.returncode), exr_equals_main_fused=same, manifest=manifest,
          seconds=f"{load_s:.1f}", stderr_tail=res.stderr.strip().splitlines()[-1:])
    from ipu_path_trace_tpu_torch.tools import turntable
    from ipu_path_trace_tpu_torch.ui.video import iter_mp4_samples

    for f in counters:
        f.launches = 0
    for f in plains:
        f.cuda_runs = 0
    tt_frames = 4
    tt = turntable.render_turntable(MAIN_W, MAIN_H, MAIN_SPS, tt_frames, 8, str(ROOT / ASSET),
                                    outfile=str(out_dir / "turntable.mp4"), codec="mjpeg")
    samples = list(iter_mp4_samples((out_dir / "turntable.mp4").read_bytes()))
    got = [f.launches for f in counters]
    print(f"[timing] turntable {MAIN_W}x{MAIN_H}, {MAIN_SPS} spp, {tt_frames} frames: "
          f"{tt['seconds_per_frame']:.3f} s per frame ({smi})", flush=True)
    phase("turntable", len(samples) == tt_frames and all(x[:2] == b"\xff\xd8" for x in samples)
          and len(set(samples)) == tt_frames and got == [0, 0, tt_frames, 0]
          and not any(f.cuda_runs for f in plains), frames=len(samples),
          launches_trace_shade_megastep_apply=got,
          seconds_per_frame=f"{tt['seconds_per_frame']:.3f}")

    # 6d. the interactive path: --ui-port --denoise with the port's client --
    from ipu_path_trace_tpu_torch.ui.video import make_encoder

    enc = make_encoder(MAIN_W, MAIN_H)
    codec = enc.codec
    enc.close()
    mjpeg = codec.startswith("mjpeg")
    print(f"[ui] render_preview codec make_encoder picks at {MAIN_W}x{MAIN_H}: {codec}",
          flush=True)
    headless_step = statistics.median(step_s["main fused"])
    ui_runs = {}
    for name, flags in (("ui host film", []), ("ui device film", ["--device-film"]),
                        ("ui host film int8", int8_flags),
                        ("ui device film int8", ["--device-film", *int8_flags])):
        r = ui_run(name, flags, out_dir, app_log, counters, plains)
        calls, got = r["host_calls"], r["launches"]
        film_calls = calls["accumulate"] + calls["accumulate_soa"]
        plain_calls = [calls[k] for k in ("accumulate_plain", "tone_map_plain", "jpeg_plain")]
        int8_ok = (r["int8_launches_after_swap"] or 0) > 0 if "int8" in name else True
        ok = (r["rc"] == 0 and not r["alive"] and r["previews"] and r["exposure_no_restart"]
              and r["fov_restart"] and r["load_nif_restart"] and r["samples_16_restart"]
              and got["megastep"] > 0 and got["nif_apply"] > 0 and got["trace"] == 0
              and got["env_shade"] == 0 and not any(r["plain_runs_on_cuda"])
              and film_calls > 0 and calls["tonemap"] > 0 and not any(plain_calls)
              and (calls["jpeg_scan"] > 0) == mjpeg and (r["frames_ok"] or not mjpeg)
              and int8_ok)
        step = statistics.median(r["step_s"][1:]) if len(r["step_s"]) > 1 else None
        phase(name, ok, rc=r["rc"], previews=r["preview_count"],
              decoded_frames=r["decoded_frames"], exposure_no_restart=r["exposure_no_restart"],
              fov_restart=r["fov_restart"], load_nif_restart=r["load_nif_restart"],
              samples_16_restart=r["samples_16_restart"],
              launches_trace_shade_megastep_apply=list(got.values()),
              int8_megastep_launches_after_load_nif=r["int8_launches_after_swap"],
              native_jpeg_calls=calls["jpeg_scan"], native_film_calls=film_calls,
              native_tonemap_calls=calls["tonemap"], plain_calls=plain_calls,
              wall_s=f"{r['wall_s']:.2f}")
        print(f"[timing] {name} ({smi}): median step {step} s with the UI (8 then 16 spp), "
              f"{headless_step:.4f} s headless (main fused, 8 spp); stream "
              f"{r['stream_bytes']} bytes", flush=True)
        ui_runs[name] = {k: (str(v) if isinstance(v, Path) else v) for k, v in r.items()}
    ui_parts = ui_components(out_dir, smi, counters, plains)

    # 6f. the NIF tools: train, check, render with and quantise new assets --
    trained = train_phase(out_dir, smi, dev, counters, plains, scene, k3_256)
    for k, e in trained["err"].items():
        err[k] = max(err[k], e)

    # 10. the accuracy acceptance, validation, width 384 and the NIF tools --
    accuracy = accuracy_phase(out_dir, smi, dev, counters, plains)

    # 11. the device mesh on one card ---------------------------------------
    mesh_res = mesh_phase(out_dir, smi, dev, counters, plains, app_log, lum, split, bake_chunks)

    # 12. the studies ---------------------------------------------------------
    studies = study_phase(out_dir, smi, dev, counters, plains)

    # 7. checks and timing at the main path's shapes ------------------------
    # 1,104,000 lanes end in a partial block, so the kernels' tail masks run
    # here.  These launches come after the counters were read above.
    cols, rows = grid(MAIN_W, MAIN_H)
    settings = RenderSettings.make(samples_per_step=MAIN_SPS)
    kw = dict(width=MAIN_W, height=MAIN_H, max_path_length=10)
    seed = (5, 6)
    esc = trace.trace_sample(scene, settings, cols, rows, seed, **kw)
    err["trace"] = max(k1_err, trace_exact(
        "K1 philox 1104x1000 sample 0", esc,
        trace.trace_sample_plain(scene, settings, cols, rows, seed, **kw)))
    for name, m in (("env_shade", model), ("env_shade_int8", q8)):
        err[name] = max(err[name], shade_check(
            f"K2 {'int8 ' if is_int8(m) else ''}1104x1000 escapes", m, esc.esc_dir, esc.esc_w,
            settings.azimuth))
    for name, m in (("megastep", model), ("megastep_int8", q8)):
        err[name] = max(err[name], megastep_check(
            f"K3 {'int8 ' if is_int8(m) else ''}philox 1104x1000 {MAIN_SPS} samples",
            megastep.render_megastep(scene, settings, m, cols, rows, seed, **kw),
            megastep.render_megastep_plain(scene, settings, m, cols, rows, seed, **kw),
            is_int8(m)))
    # One bake chunk at the default --max-nif-batch-size: rows 0..9 of the
    # 2048x4096 lattice, as models/envlight.bake_nif_env lays it out.
    bake_h, bake_w = meta.image_shape[:2]
    bake_u = (torch.arange(BAKE_ROWS, dtype=torch.float32, device=dev) / (bake_h - 1)
              ).repeat_interleave(bake_w)
    bake_v = torch.linspace(0.0, 1.0, bake_w, device=dev).repeat(BAKE_ROWS)
    for name, m in (("nif_apply", model), ("nif_apply_int8", q8)):
        err[name] = max(err[name], apply_check(
            f"K4 {'int8 ' if is_int8(m) else ''}bake chunk {BAKE_ROWS}x{bake_w}", m, bake_u,
            bake_v))
    # Phase 5b's modes at the main path's shapes, host noise for 8 samples
    # made on the card.
    noise_gen = torch.Generator(device=dev).manual_seed(2025)
    noise8 = torch.rand((MAIN_SPS, 4 + 4 * kw["max_path_length"], cols.shape[0]),
                        generator=noise_gen, device=dev)
    noise8[:, 0:2] = torch.randn((MAIN_SPS, 2, cols.shape[0]), generator=noise_gen, device=dev)
    # K1 bit for bit in its three modes, at the full frame and at a ragged
    # 65,317 lanes (the persistent warps' last batches end mid-warp).
    sob_k1 = sobol_ctx(cols, rows, MAIN_W)
    for tag, m in (("1104x1000", cols.shape[0]), (f"ragged {RAGGED_K3}", RAGGED_K3)):
        c, r = cols[:m].contiguous(), rows[:m].contiguous()
        sob_m = (sob_k1[0][:m].contiguous(), sob_k1[1][:m].contiguous(), sob_k1[2])
        for mode, key, args in (
                ("philox", "trace", dict(seed=seed, sample_index=3)),
                ("sobol", "trace_sobol", dict(seed=seed, sample_index=3, sobol=sob_m,
                                              sobol_dims=SOBOL_DIMS)),
                ("host-noise", "trace", dict(noise=noise8[0, :, :m].contiguous()))):
            err[key] = max(err.get(key, 0.0), trace_exact(
                f"K1 {mode} {tag}", trace.trace_sample(scene, settings, c, r, **args, **kw),
                trace.trace_sample_plain(scene, settings, c, r, **args, **kw)))
    mode_checks("1104x1000", cols, rows, kw, settings, seed, noise8)
    del noise8
    stub_checks("1104x1000", cols, rows, kw, settings, seed)
    times, library_ms, int_mm_products = {}, {}, {}

    def versus(a, b, a_reps, b_reps):
        """b, a, a, b: two versions in turns on one card; ms per call of each."""
        b1 = cuda_ms(b, b_reps)
        a1 = cuda_ms(a, a_reps)
        a2 = cuda_ms(a, a_reps)
        b2 = cuda_ms(b, b_reps)
        return (a1 + a2) / 2, (b1 + b2) / 2

    def turns(name, kernel, plain, k_reps, p_reps, k_per=1, unit="full-frame sample"):
        """The kernel and its plain version in turns; ms per unit (a kernel
        launch may render k_per)."""
        k, p = versus(kernel, plain, k_reps, p_reps)
        times[name] = (k / k_per, p)
        print(f"[timing] {name}: kernel {times[name][0]:.3f} ms, plain "
              f"{times[name][1]:.3f} ms per {unit}", flush=True)

    turns("trace",
          lambda: trace.trace_sample(scene, settings, cols, rows, seed, **kw),
          lambda: trace.trace_sample_plain(scene, settings, cols, rows, seed, **kw), 10, 2)
    one = settings._replace(samples_per_step=1)
    for m, suffix in ((model, ""), (q8, "_int8")):
        turns(f"env_shade{suffix}",
              lambda: nif.nif_env_shade(m, esc.esc_dir, esc.esc_w, settings.azimuth),
              lambda: nif.nif_env_shade_plain(m, esc.esc_dir, esc.esc_w, settings.azimuth),
              10, 2)
        turns(f"megastep{suffix}",  # kernel: 8-sample launches, as the main path; plain: 1
              lambda: megastep.render_megastep(scene, settings, m, cols, rows, seed, **kw),
              lambda: megastep.render_megastep_plain(scene, one, m, cols, rows, seed, **kw),
              3, 2, k_per=MAIN_SPS)
        turns(f"nif_apply{suffix}",
              lambda: nif.nif_apply_t(m, bake_u, bake_v),
              lambda: nif.nif_apply_t_plain(m, bake_u, bake_v), 50, 4,
              unit=f"bake chunk of {BAKE_ROWS * bake_w} points")
    for name in ("megastep", "megastep_int8"):
        print(f"[timing] {name} fused step device rate: "
              f"{MAIN_W * MAIN_H / times[name][0] / 1e3:.1f} Mpaths/s (information only)")

    # The new modes.  Budgets of 8 for every block (the uniform step's
    # work) time the budget and statistics path itself; the plain version
    # renders one sample (budgets of 1).
    sob = sobol_ctx(cols, rows, MAIN_W)
    groups = -(-cols.shape[0] // megastep.BUDGET_BLOCK)
    eights = torch.full((groups,), MAIN_SPS, dtype=torch.int32, device=dev)
    ones = torch.ones_like(eights)
    sobol = dict(sobol=sob, sobol_dims=SOBOL_DIMS)
    turns("trace_sobol",
          lambda: trace.trace_sample(scene, settings, cols, rows, seed, **sobol, **kw),
          lambda: trace.trace_sample_plain(scene, settings, cols, rows, seed, **sobol, **kw),
          10, 2)
    # K1 alone: one prepared launch (ops/trace.prepare_trace) back to back,
    # the wrapper's checks, parameters, tables and outputs paid once; K1's
    # rows report it, and the wrapper's time (above) beside it.
    for name, extra in (("trace", {}), ("trace_sobol", sobol)):
        run = trace.prepare_trace(scene, settings, cols, rows, seed, **extra, **kw)
        wrapper = times[name][0]
        times[name + "_wrapper"] = (wrapper, None)
        times[name] = (cuda_ms(run.launch, 50), times[name][1])
        print(f"[timing] {name}: kernel alone {times[name][0]:.4f} ms, wrapper {wrapper:.4f} ms "
              f"per full-frame sample ({smi})", flush=True)
        del run
    ecols, erows = grid(MAIN_W, MAIN_H, enclosed)
    for name, m, sc, c, r, k_args, p_args in (
            ("megastep_sobol", model, scene, cols, rows, sobol, sobol),
            ("megastep_budgets_stats", model, scene, cols, rows,
             dict(budgets=eights, with_stats=True), dict(budgets=ones, with_stats=True)),
            ("megastep_enclosed", model, enclosed, ecols, erows, {}, {}),
            ("megastep_int8_sobol_budgets_stats", q8, scene, cols, rows,
             dict(budgets=eights, with_stats=True, **sobol),
             dict(budgets=ones, with_stats=True, **sobol))):
        turns(name,
              lambda: megastep.render_megastep(sc, settings, m, c, r, seed, **k_args, **kw),
              lambda: megastep.render_megastep_plain(sc, one, m, c, r, seed, **p_args, **kw),
              3, 2, k_per=MAIN_SPS)
    # K3 where no ray escapes against the open scene: the enclosed scene's
    # blocks queue nothing and shade no tile, so K3 is the trace alone and
    # 1 - enclosed/open is the NIF chain's share of K3.
    enclosed_ms = {}
    for m, chain in ((model, "bf16"), (q8, "int8")):
        closed, opened = versus(
            lambda: megastep.render_megastep(enclosed, settings, m, ecols, erows, seed, **kw),
            lambda: megastep.render_megastep(scene, settings, m, cols, rows, seed, **kw), 3, 3)
        enclosed_ms[chain] = (closed / MAIN_SPS, opened / MAIN_SPS)
        print(f"[timing] K3 {chain} enclosed vs open scene: {closed / MAIN_SPS:.3f} vs "
              f"{opened / MAIN_SPS:.3f} ms per full-frame sample", flush=True)
    # K3's stubs at the main path's shapes (bf16, Philox), as the device
    # timing launches them; the 'trace' stub (the chain with the bounce
    # stubbed) less the skeleton is the chain alone, beside the split's env.
    for stub in megastep.STUBS:
        turns(f"megastep_stub_{stub}",
              lambda: megastep.render_megastep(scene, settings, model, cols, rows, seed, stub=stub,
                                               **kw),
              lambda: megastep.render_megastep_plain(scene, one, model, cols, rows, seed,
                                                     stub=stub, **kw),
              3, 2, k_per=MAIN_SPS)
    chain_alone = times["megastep_stub_trace"][0] - times["megastep_stub_both"][0]
    print(f"[timing] the chain alone ('trace' stub - 'both' stub): {chain_alone:.4f} ms per "
          f"full-frame sample, against the split's env {split.get('env_ms', 0.0):.3f} ms "
          f"({smi}; information only)", flush=True)
    step_ms, k3_ms = split.get("step_ms", 0.0), times["megastep"][0]
    phase("device timing step vs K3", abs(step_ms - k3_ms) <= 0.1 * k3_ms,
          step_ms=f"{step_ms:.4f}", k3_ms_per_sample=f"{k3_ms:.4f}",
          ratio=f"{step_ms / k3_ms:.4f}")
    k3_step = MAIN_SPS * k3_ms
    print(f"[timing] ui vs K3 ({smi}): denoised device preview "
          f"{ui_parts['device_preview_denoised_ms']:.3f} ms, denoise "
          f"{ui_parts['denoise_ms']:.3f} ms, device preview "
          f"{ui_parts['device_preview_ms']:.3f} ms, "
          f"JPEG encode {ui_parts['jpeg_encode_ms']:.3f} ms against K3's {MAIN_SPS}-spp step "
          f"{k3_step:.3f} ms: the denoised preview takes "
          f"{ui_parts['device_preview_denoised_ms'] / k3_step:.2f}x the step", flush=True)
    # Repeated launches of K1 and K3 wait for nothing on the host: under the
    # sync debug mode "error" a device-to-host sync raises.  The control,
    # the launch parameters' fov computed anew (a read-back), must raise.
    def sync_free(fn) -> str:
        """'' if three launches after a warm-up sync nowhere, else the error."""
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                fn()
            return ""
        except RuntimeError as e:
            return str(e).splitlines()[0] if str(e) else type(e).__name__
        finally:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()

    host_noise = torch.rand((1, 4 + 4 * kw["max_path_length"], cols.shape[0]), device=dev)
    control = sync_free(lambda: trace._tan_fov.__wrapped__(settings.fov, MAIN_W, MAIN_H, dev))
    syncs = {name: sync_free(fn) for name, fn in (
        ("K1 philox", lambda: trace.trace_sample(scene, settings, cols, rows, seed, **kw)),
        ("K1 sobol", lambda: trace.trace_sample(scene, settings, cols, rows, seed, **sobol, **kw)),
        ("K1 host-noise", lambda: trace.trace_sample(scene, settings, cols, rows,
                                                     noise=host_noise[0], **kw)),
        ("K3 bf16 philox", lambda: megastep.render_megastep(scene, settings, model, cols, rows,
                                                            seed, **kw)),
        ("K3 bf16 host-noise", lambda: megastep.render_megastep(scene, settings, model, cols,
                                                                rows, noise=host_noise, **kw)),
        ("K3 int8 sobol budgets stats", lambda: megastep.render_megastep(
            scene, settings, q8, cols, rows, seed, budgets=eights, with_stats=True, **sobol,
            **kw)))}
    del host_noise
    phase("no host sync in repeated K1 and K3 launches", bool(control)
          and not any(syncs.values()), control_raised=control[:60],
          synced={k: v for k, v in syncs.items() if v})
    unfused = devtime.measure_phases(
        scene, settings, StaticConfig(width=MAIN_W, height=MAIN_H, max_path_length=10,
                                      use_fused_step=False),
        to_device_batch(coherent_order(create_tracing_jobs(MAIN_W, MAIN_H), scene, MAIN_W, MAIN_H,
                                       90.0), dev), seed, NifEnv(model), loop=MAIN_SPS, reps=1)
    phase("device timing unfused", unfused["trace_ms"] > 0 and unfused["env_ms"] > 0,
          **{k: f"{v:.4f}" for k, v in unfused.items() if k.endswith("_ms")})
    # What the bounds count: the escapes and bounces of this run's data.
    # K3's sample s draws K1's Philox sample s, bit for bit (phase 3).
    escapes = bounces = 0
    for s in range(MAIN_SPS):
        st = trace.trace_sample(scene, settings, cols, rows, seed, sample_index=s, **kw)
        escapes += int(st.escaped.sum())
        bounces += int(st.path_len.sum())
    escapes_enclosed = bounces_enclosed = 0
    for s in range(MAIN_SPS):
        st = trace.trace_sample(enclosed, settings, ecols, erows, seed, sample_index=s, **kw)
        escapes_enclosed += int(st.escaped.sum())
        bounces_enclosed += int(st.path_len.sum())
    print(f"[bound] 1104x1000, {MAIN_SPS} samples: {escapes} escapes, {bounces} bounces "
          f"(enclosed scene {escapes_enclosed}, {bounces_enclosed})", flush=True)
    # The cuBLAS bf16 chain at the kernels' shapes: K2/K3's full frame and
    # K4's bake chunk.
    gate_batch = 1 << 19  # the quality gate's batch (probes/quant_psnr.py)
    gate_u, gate_v = torch.rand((2, gate_batch), generator=noise_gen, device=dev)
    times["nif_apply_gate_batch"] = (cuda_ms(lambda: nif.nif_apply_t(model, gate_u, gate_v), 10),
                                     None)
    print(f"[timing] nif_apply bf16 (wgmma) at {gate_batch} points: "
          f"{times['nif_apply_gate_batch'][0]:.4f} ms ({smi})", flush=True)
    for tag, npts in (("full frame", cols.shape[0]), ("bake chunk", bake_u.shape[0]),
                      ("gate batch", gate_batch)):
        feats = torch.rand((npts, 4 * model.embedding_dim), device=dev).to(torch.bfloat16)
        times[f"cublas_chain_{tag}"] = (
            cuda_ms(lambda: tf32_chain.library_chain(model, feats), 10), None)
        print(f"[timing] cuBLAS bf16 chain (7 products, relu, concat) at {npts} rays: "
              f"{times[f'cublas_chain_{tag}'][0]:.3f} ms ({smi}; a yardstick, not the port)",
              flush=True)
        del feats
    # The int8 analog: the torch._int_mm chain with K5's epilogue at the
    # full frame (K2, K3) and the bake chunk (K4), each the library time of
    # the int8 rows; and its seven products alone, the least any such chain
    # takes (its time is mostly the eager epilogue's passes over f32).
    from ipu_path_trace_tpu_torch.models.quant import quantize_features

    for names, npts in ((("env_shade_int8", "megastep_int8", "megastep_int8_sobol_budgets_stats"),
                         cols.shape[0]), (("nif_apply_int8",), bake_u.shape[0])):
        codes = quantize_features(
            torch.rand((npts, 4 * q8.embedding_dim), device=dev) * 2.0 - 1.0)
        ms = cuda_ms(int_mm_chain(q8, codes), 10)
        times[f"int_mm_chain_{npts}"] = (ms, None)
        products = cuda_ms(int_mm_chain(q8, codes, epilogue=False), 10)
        times[f"int_mm_products_{npts}"] = (products, None)
        for name in names:
            library_ms[name] = ms
            int_mm_products[name] = products
        print(f"[timing] torch._int_mm int8 chain (7 products, K5's epilogue) at {npts} rays: "
              f"{ms:.3f} ms, the products alone {products:.3f} ms ({smi}; yardsticks, not "
              f"the port)", flush=True)
        del codes

    for chain, (closed, opened) in enclosed_ms.items():
        phase(f"K3 {chain} shades no tile on the enclosed scene", closed < 0.25 * opened,
              enclosed_ms=f"{closed:.3f}", open_ms=f"{opened:.3f}",
              chain_share=f"{1 - closed / opened:.2%}")
    # The adaptive step against the uniform one, from the state of one
    # cold (uniform) and one adaptive step of the device film.
    static = StaticConfig(width=MAIN_W, height=MAIN_H, max_path_length=kw["max_path_length"],
                          adaptive_min=ADAPTIVE_MIN)
    env = NifEnv(model)
    work = to_device_batch(
        coherent_order(create_tracing_jobs(MAIN_W, MAIN_H), scene, MAIN_W, MAIN_H, 90.0), dev)
    lum2 = torch.zeros(work.u.shape[0], dtype=torch.float32, device=dev)
    for s in range(2):
        work, lum2 = adaptive_render_step(scene, settings, static, work, lum2, (9, s), env)
    min_spp, cap = adaptive_caps(static, MAIN_SPS)
    budgets = compute_budgets(work.r, work.g, work.b, lum2, work.sample_count,
                              block_size=megastep.BUDGET_BLOCK, samples_per_step=MAIN_SPS,
                              min_spp=min_spp, max_spp=cap)
    ada, uni = versus(lambda: adaptive_render_step(scene, settings, static, work, lum2, seed, env),
                      lambda: render_step(scene, settings, static, work, seed, env), 3, 3)
    times["adaptive_step"] = (ada, uni)
    print(f"[timing] adaptive step {ada:.3f} ms vs uniform step {uni:.3f} ms ({ada / uni - 1:+.2%});"
          f" budgets min {int(budgets.min())} max {int(budgets.max())} (cap {cap}), total "
          f"{int(budgets.sum())} of {groups * MAIN_SPS}", flush=True)

    # 8. the overlap probes K6/K7 -------------------------------------------
    from ipu_path_trace_tpu_torch.probes import overlap

    pmodel = overlap.probe_model(dev)
    pu = torch.linspace(0.0, 1.0, overlap.LANES, dtype=torch.float32, device=dev)
    probe_fns = {  # name: (kernel, plain, what it is held to)
        "overlap_mxu": (lambda: overlap.overlap_mxu(pmodel, pu),
                        lambda: overlap.mxu_plain(pmodel, pu), "chain"),
        "overlap_alu": (lambda: overlap.overlap_alu(pu), lambda: overlap.alu_plain(pu), "alu"),
        "overlap_both": (lambda: overlap.overlap_both(pmodel, pu),
                         lambda: overlap.both_plain(pmodel, pu), "chain"),
        **{f"overlap_{v.replace('+', '_')}": (
            lambda v=v: overlap.overlap_loop(pmodel, pu, v),
            lambda v=v: overlap.loop_plain(pmodel, pu, *overlap.LOOP_VARIANTS[v]), "chain")
           for v in overlap.LOOP_VARIANTS},
    }
    for name, (kern, plain, kind) in probe_fns.items():
        got, ref = kern(), plain()
        err[name] = float((got - ref).abs().max())
        if kind == "chain":
            med, mx = nif_rel(got, ref)
            ok = med < NIF_MEDIAN and mx < NIF_MAX
            info = dict(median_rel=f"{med:.2e}", max_rel=f"{mx:.2e}")
        else:
            off = float(((got - ref).abs() > 1e-5 * ref.abs()).float().mean())
            ok = off <= FLIP_FRACTION
            info = dict(lanes_off=f"{off:.2e}")
        phase(f"K6/K7 {name}", ok and bool(torch.isfinite(got).all()), **info,
              max_abs_err=f"{err[name]:.3e}")
    for f in (overlap.overlap_mxu, overlap.overlap_alu, overlap.overlap_both):
        f.launches = 0
    overlap.overlap_loop.launches = dict.fromkeys(overlap.LOOP_VARIANTS, 0)
    probe_ms = overlap.main()  # the probes' entry point: its lines on stdout
    launches["probes"] = {"overlap_mxu": overlap.overlap_mxu.launches,
                          "overlap_alu": overlap.overlap_alu.launches,
                          "overlap_both": overlap.overlap_both.launches,
                          **{f"overlap_{v.replace('+', '_')}": n
                             for v, n in overlap.overlap_loop.launches.items()}}
    phase("probe launches", launches["probes"] == {
        **dict.fromkeys(("overlap_mxu", "overlap_alu", "overlap_both"), 25),
        **{f"overlap_{v.replace('+', '_')}": 4 for v in overlap.LOOP_VARIANTS}},
        launches=launches["probes"])
    probe_lines = {"overlap_mxu": "mxu only", "overlap_alu": "vpu only", "overlap_both": "both",
                   **{f"overlap_{v.replace('+', '_')}": v for v in overlap.LOOP_VARIANTS}}
    # The library yardsticks (never called by the port): the probe's seven
    # products as the cuBLAS bf16 chain over the lanes' features, plus the
    # eager ALU rounds where the kernel has them ('both', the loops).
    def library_chain(m, v):
        return tf32_chain.library_chain(m, v.to(torch.bfloat16)[:, None].expand(-1, 4 * m.embedding_dim))[:, 0]

    k6_rounds = overlap.per_layer(overlap.K6_ROUNDS) * len(overlap.LAYERS)
    library_ms["overlap_mxu"] = cuda_ms(lambda: library_chain(pmodel, pu), 10)
    library_ms["overlap_both"] = cuda_ms(
        lambda: library_chain(pmodel, pu) + overlap.alu_plain(pu, k6_rounds), 10)
    for v, flags in overlap.LOOP_VARIANTS.items():
        library_ms[f"overlap_{v.replace('+', '_')}"] = cuda_ms(
            lambda flags=flags: overlap.loop_plain(pmodel, pu, *flags, chain=library_chain), 1)
    for name, (_, plain, _) in probe_fns.items():
        per = overlap.LOOP if name.startswith("overlap_loop") else 1  # ms per kernel call
        times[name] = (probe_ms[probe_lines[name]] * per, cuda_ms(plain, 1))
        print(f"[timing] {name}: kernel {times[name][0]:.3f} ms, plain {times[name][1]:.3f} ms, "
              f"library chain {library_ms.get(name, float('nan')):.3f} ms per call of "
              f"{overlap.LANES} lanes ({smi})", flush=True)
    # K7 on the wgmma tile against its library chain (the cuBLAS chain and
    # the eager ALU rounds per iteration), each variant, in this run.
    loops = [f"overlap_{v.replace('+', '_')}" for v in overlap.LOOP_VARIANTS]
    phase("K7 beats its library chain", all(times[k][0] < library_ms[k] for k in loops),
          **{f"{k[8:]}_ms": f"{times[k][0]:.3f}" for k in loops},
          **{f"{k[8:]}_library_ms": f"{library_ms[k]:.3f}" for k in loops})

    # 9. K8, the precision probe, and the on-class quality gate ------------
    from ipu_path_trace_tpu_torch.models import reconstruct
    from ipu_path_trace_tpu_torch.probes import quant, quant_psnr

    t9 = time.monotonic()
    k8_ops = {}
    for variant in quant.VARIANTS:
        feats, ws, bs, _, xmax = quant.calibration(None if variant == "bf16" else quant.PAD)
        ops = k8_ops[variant] = quant.build_operands(variant, ws, bs, feats, xmax).to(dev)
        got, ref = quant.quant_probe(ops), quant.probe_plain(ops)
        name = f"quant_probe_{variant}"
        err[name] = float((got - ref).abs().max())
        rel = rel_err(got, ref)
        med, mx = float(rel.median()), float(rel.max())
        if variant == "bf16":  # K8's own budget; every launch the same outputs
            same = all(torch.equal(quant.quant_probe(ops), got)
                       for _ in range(K8_BF16_LAUNCHES - 1))
            above = float((rel > K8_BF16_ABOVE).float().mean())
            ok = (same and med < K8_BF16_MEDIAN and above <= K8_BF16_FRACTION
                  and mx < K8_BF16_MAX)
            print(f"[K8] bf16 on the wgmma tile vs its plain version, {quant.RAYS} outputs x 3, "
                  f"{K8_BF16_LAUNCHES} launches all equal: {same}; max rel {mx:.4e}, outputs "
                  f"past {K8_BF16_ABOVE:g}: {above:.3e} ({smi})", flush=True)
        elif variant.startswith("fp8"):
            above = float((rel > FP8_ABOVE).float().mean())
            ok = med < FP8_MEDIAN and above <= FP8_FRACTION and mx < FP8_MAX
        else:
            above, ok = float((got != ref).float().mean()), torch.equal(got, ref)
        phase(f"K8 {variant}", ok and bool(torch.isfinite(got).all())
              and got.shape == (3 if variant == "bf16" else 8, quant.RAYS),
              equal=torch.equal(got, ref), median_rel=f"{med:.2e}", max_rel=f"{mx:.2e}",
              outputs_above=f"{above:.2e}", max_abs_err=f"{err[name]:.3e}")
        del got, ref, rel
    quant.quant_probe.launches = dict.fromkeys(quant.VARIANTS, 0)
    k8_res = quant.main(["--iters", str(K8_ITERS)])  # the probe's entry point: its lines
    launches["quant_probe"] = dict(quant.quant_probe.launches)
    # main: one run, then time_per_call's warm-up + 1 and warm-up + K8_ITERS.
    phase("K8 probe launches", launches["quant_probe"]
          == dict.fromkeys(quant.VARIANTS, 4 + K8_ITERS), launches=launches["quant_probe"])
    for variant, ops in k8_ops.items():
        name = f"quant_probe_{variant}"
        entry = k8_res["variants"][variant]
        times[name] = (entry["ms_per_sample"], cuda_ms(lambda: quant.probe_plain(ops), 1))
        library_ms[name] = cuda_ms(library_k8(ops), 10)
        print(f"[timing] {name}: kernel {times[name][0]:.3f} ms "
              f"({entry.get('speedup_vs_bf16', 1.0):.3f}x bf16), plain {times[name][1]:.3f} ms, "
              f"library chain {library_ms[name]:.3f} ms per {quant.RAYS}-ray sample; rel err vs "
              f"f32 {entry['rel_err_vs_f32']:.3e} ({smi})", flush=True)
    k8_sass = sass_mma_counts(lib_path)
    for key, counts in sorted(k8_sass.items()):
        print(f"[sass] quant_probe {key}: {counts}", flush=True)
    # Every variant on the wgmma tiles, its chain's wgmma alone (bf16 and
    # fp8 HGMMA, int8 IGMMA; no HMMA, IMMA, QMMA or QGMMA), no mma.sync
    # kernel of K6, K7 or K8 left in the library, no spills; likewise K6
    # 'mxu' and 'both' and K7's four loops.
    for kernel, names in (("K8", quant.VARIANTS), ("K6", tuple(K6_NAMES.values())),
                          ("K7", tuple(K7_NAMES.values()))):
        wg = {k[3:]: v for k, v in wg_sass.items() if k.startswith(f"{kernel} ")}
        phase(f"SASS {kernel} {', '.join(names)}", functions is not None
              and sorted(wg) == sorted(names) and all(holds_its_chain(v) for v in wg.values())
              and not any(OLD_MMA_SYNC.search(name) for name, _ in functions),
              **{k: f"{v[OWN_MMA[v['chain']]]}/{v['HMMA'] + v['IMMA'] + v['QMMA']}"
                 for k, v in wg.items()})
        phase(f"ptxas {kernel} no spills", len(wg) == len(names)
              and all(v["ptxas"] and v["spill_bytes"] == 0 for v in wg.values()),
              spill_bytes={k: v["spill_bytes"] for k, v in wg.items()})
    # No kernel of the library holds an mma.sync instruction (HMMA, IMMA,
    # QMMA): every chain runs on wgmma.
    mma_sync = {name: {op: c for op, c in mma_counts(part).items()
                       if op in ("HMMA", "IMMA", "QMMA") and c}
                for name, part in functions or []}
    mma_sync = {name: c for name, c in mma_sync.items() if c}
    phase("SASS library has no mma.sync", functions is not None and not mma_sync,
          kernels=len(functions or []), with_mma_sync=mma_sync)
    # The quality gate through its entry point, then once more with the
    # plain versions in place of K4 (same batches, same frames).
    nif.nif_apply_t.launches = nif.nif_apply_t_plain.cuda_runs = 0
    t0 = time.monotonic()
    quality = quant_psnr.main([])
    gate_s = time.monotonic() - t0
    gate_launches = nif.nif_apply_t.launches
    frame = 2048 * 4096
    # bf16 and f32 through reconstruct_image's batches, int8 in fixed chunks.
    batches = 2 * reconstruct.batch_split(frame, 1 << 19)[0] + -(-frame // (1 << 19))
    kernel_apply = nif.nif_apply_t
    reconstruct.nif_apply_t = quant_psnr.nif_apply_t = nif.nif_apply_t_plain
    try:
        quality_plain = quant_psnr.main([])
    finally:
        reconstruct.nif_apply_t = quant_psnr.nif_apply_t = kernel_apply
    phase("quality gate launches", gate_launches == batches
          and nif.nif_apply_t.launches == gate_launches
          and nif.nif_apply_t_plain.cuda_runs == batches,
          k4_launches=gate_launches, batches=batches,
          plain_runs_on_cuda=nif.nif_apply_t_plain.cuda_runs, seconds=f"{gate_s:.1f}")
    for key in ("bf16_psnr_db", "int8_psnr_db", "f32_psnr_db"):
        gap_db = abs(quality[key] - quality_plain[key])
        phase(f"quality gate {key}", gap_db <= PSNR_GAP_DB and math.isfinite(quality[key]),
              k4=f"{quality[key]:.4f}", plain=f"{quality_plain[key]:.4f}", gap_db=f"{gap_db:.2e}")
    print(f"[timing] phase 9 (K8 and the quality gate): {time.monotonic() - t9:.1f} s",
          flush=True)

    # The wgmma chains against the cuBLAS chain of the same run.
    cublas_frame = times["cublas_chain_full frame"][0]
    for name, chain_key, unit in (
            ("env_shade", "cublas_chain_full frame",
             f"1104x1000 sample ({cols.shape[0]} lanes)"),
            ("nif_apply", "cublas_chain_bake chunk", f"bake chunk ({bake_u.shape[0]} points)"),
            ("nif_apply_gate_batch", "cublas_chain_gate batch",
             f"gate batch ({gate_batch} points)")):
        print(f"[wgmma] {name} bf16: {times[name][0]:.4f} ms per {unit}, cuBLAS chain "
              f"{times[chain_key][0]:.4f} ms ({times[name][0] / times[chain_key][0]:.3f}x); "
              f"({smi})", flush=True)
    print(f"[wgmma] K6 mxu {times['overlap_mxu'][0]:.4f} ms per {overlap.LANES} lanes, its "
          f"cuBLAS chain {library_ms['overlap_mxu']:.4f}; K8 per {quant.RAYS} rays: "
          + ", ".join(f"{v} {times[f'quant_probe_{v}'][0]:.4f} ms" for v in quant.VARIANTS)
          + f" ({smi})", flush=True)
    phase("K2 bf16 wgmma beats the cuBLAS chain", times["env_shade"][0] < cublas_frame,
          env_shade_ms=f"{times['env_shade'][0]:.4f}", cublas_chain_ms=f"{cublas_frame:.4f}")
    # K3 bf16 on the same chain, each mode per 1104x1000 sample, beside the
    # unfused step (K1 + K2), the library chain and the device timing split.
    k3_modes = {k: times[f"megastep{k and '_' + k}"][0] for k in (
        "", "sobol", "budgets_stats", "enclosed")}
    print(f"[wgmma] K3 bf16 per 1104x1000 sample: "
          + ", ".join(f"{k or 'philox'} {v:.4f} ms" for k, v in k3_modes.items())
          + f"; int8 K3 {times['megastep_int8'][0]:.4f} ms; K2 bf16 {times['env_shade'][0]:.4f} ms;"
          f" unfused step {unfused['step_ms']:.4f} ms (trace {unfused['trace_ms']:.4f}, env "
          f"{unfused['env_ms']:.4f}); cuBLAS chain {times['cublas_chain_full frame'][0]:.4f} ms; "
          f"device timing split step {split.get('step_ms', 0.0):.4f} = env "
          f"{split.get('env_ms', 0.0):.4f} + trace {split.get('trace_ms', 0.0):.4f} + overhead "
          f"{split.get('overhead_ms', 0.0):.4f} ms ({smi})", flush=True)
    phase("K3 bf16 wgmma beats the cuBLAS chain", times["megastep"][0] < cublas_frame,
          megastep_ms=f"{times['megastep'][0]:.4f}", cublas_chain_ms=f"{cublas_frame:.4f}")
    # K6 'mxu' against the cuBLAS chain of the probe's layers over the same
    # lanes, and K8's fp8 variants against the torch._scaled_mm chain.
    phase("K6 mxu beats the cuBLAS chain", times["overlap_mxu"][0] < library_ms["overlap_mxu"],
          overlap_mxu_ms=f"{times['overlap_mxu'][0]:.4f}",
          cublas_chain_ms=f"{library_ms['overlap_mxu']:.4f}")
    fp8 = [f"quant_probe_{v}" for v in quant.VARIANTS if v.startswith("fp8")]
    phase("K8 fp8_e4m3 and fp8_raw beat the _scaled_mm chain",
          all(times[k][0] < library_ms[k] for k in fp8),
          **{f"{k[12:]}_ms": f"{times[k][0]:.4f}" for k in fp8},
          **{f"{k[12:]}_scaled_mm_chain_ms": f"{library_ms[k]:.4f}" for k in fp8})
    # The int8 chain on wgmma s8 per 1104x1000 sample (K2, K3) and bake chunk
    # (K4), beside bf16 and the torch._int_mm chain with the same epilogue.
    for name, unit in (("env_shade", "1104x1000 sample"), ("megastep", "1104x1000 sample"),
                       ("nif_apply", f"bake chunk ({bake_u.shape[0]} points)")):
        print(f"[wgmma] {name} int8 {times[name + '_int8'][0]:.4f} ms, bf16 "
              f"{times[name][0]:.4f} ms ({times[name + '_int8'][0] / times[name][0]:.3f}x), "
              f"_int_mm chain {library_ms[name + '_int8']:.4f} ms (its products alone "
              f"{int_mm_products[name + '_int8']:.4f}) per {unit} ({smi})", flush=True)
    # K3 (trace and chain) against the chain's products alone, the stricter
    # of the two yardsticks.
    phase("K3 int8 wgmma beats the _int_mm chain",
          times["megastep_int8"][0] < int_mm_products["megastep_int8"] < library_ms["megastep_int8"],
          megastep_int8_ms=f"{times['megastep_int8'][0]:.4f}",
          int_mm_products_ms=f"{int_mm_products['megastep_int8']:.4f}",
          int_mm_chain_ms=f"{library_ms['megastep_int8']:.4f}")

    # The tf32 chain against the cuBLAS f32 chain of the same products,
    # TF32 off (the f32 function: library_ms) and on (the tensor cores'
    # tf32 route), and against its bf16 twin, per phase 4d's units.
    t32 = tf32_res["times_ms"]
    for name, unit, tag in (("env_shade", "1104x1000 sample", "frame"),
                            ("megastep", "1104x1000 sample", "frame"),
                            ("nif_apply", f"bake chunk ({tf32_res['bake_chunk']} points)",
                             "bake_chunk")):
        times[f"{name}_tf32"] = (t32[f"{name}_tf32"], t32[f"{name}_tf32_plain"])
        library_ms[f"{name}_tf32"] = t32[f"cublas_f32_tf32_off_{tag}"]
        print(f"[wgmma] {name} tf32 (3xTF32) {t32[f'{name}_tf32']:.4f} ms, its bf16 twin "
              f"{t32[f'{name}_bf16']:.4f} ms ({t32[f'{name}_tf32'] / t32[f'{name}_bf16']:.2f}x), "
              f"cuBLAS f32 chain TF32 off {t32[f'cublas_f32_tf32_off_{tag}']:.4f} ms, TF32 on "
              f"{t32[f'cublas_f32_tf32_on_{tag}']:.4f} ms per {unit} ({smi})", flush=True)

    # The least time of each row's unit of work (bound), on this run's data.
    n = cols.shape[0]
    bf16_w = sum(w.numel() * 2 for w in model.kernels)
    f32_w = sum(w.numel() * 4 for w in model32.kernels)
    chain32 = 2 * NIF_MACS * tf32_res["escapes_per_sample"]  # phase 4d's data
    int8_w = sum(w.numel() for w in q8.kernels)
    trace_ops = (n * TRACE_RAY_OPS + bounces / MAIN_SPS
                 * (scene.num_spheres * SPHERE_OPS + scene.num_discs * DISC_OPS + SHADE_OPS))
    enclosed_ops = (n * TRACE_RAY_OPS + bounces_enclosed / MAIN_SPS
                    * (enclosed.num_spheres * SPHERE_OPS + enclosed.num_discs * DISC_OPS
                       + SHADE_OPS))
    chain = 2 * NIF_MACS * escapes / MAIN_SPS  # per sample, escaped rays only
    k3_bytes = n * 24 / MAIN_SPS  # cols, rows in; radiance, path length out; per sample
    stub_ray_ops = n * (TRACE_RAY_OPS + ENCODE_OPS
                        + (1 + kw["max_path_length"]) * PHILOX_GROUP_OPS)
    alu = overlap.LANES * ALU_ROUND_OPS
    lanes_chain = 2 * NIF_MACS * overlap.LANES
    # K1's draws: one noise group for the camera and one per bounce, each
    # counted at Philox's cost (in Sobol mode the first three groups cost
    # more, so the count stays a lower bound).
    k1_ops = trace_ops + (n + bounces / MAIN_SPS) * PHILOX_GROUP_OPS
    bounds = {
        "trace": least_ms(n * 52, {"f32": k1_ops}),
        "trace_sobol": least_ms(n * 60, {"f32": k1_ops}),
        "env_shade": least_ms(n * 36 + bf16_w, {"bf16": 2 * NIF_MACS * n}),
        "env_shade_int8": least_ms(n * 36 + int8_w, {"int8": 2 * NIF_MACS * n}),
        "megastep": least_ms(k3_bytes + bf16_w, {"bf16": chain, "f32": trace_ops}),
        "megastep_int8": least_ms(k3_bytes + int8_w, {"int8": chain, "f32": trace_ops}),
        "nif_apply": least_ms(bake_u.shape[0] * 20 + bf16_w,
                           {"bf16": 2 * NIF_MACS * bake_u.shape[0]}),
        "nif_apply_int8": least_ms(bake_u.shape[0] * 20 + int8_w,
                                {"int8": 2 * NIF_MACS * bake_u.shape[0]}),
        # The f32 chain's products at the tf32 peak (one pass; the kernel
        # runs 3xTF32, two or three passes).
        "env_shade_tf32": least_ms(n * 36 + f32_w, {"tf32": 2 * NIF_MACS * n}),
        "megastep_tf32": least_ms(k3_bytes + f32_w, {"tf32": chain32, "f32": trace_ops}),
        "nif_apply_tf32": least_ms(tf32_res["bake_chunk"] * 20 + f32_w,
                                   {"tf32": 2 * NIF_MACS * tf32_res["bake_chunk"]}),
        "megastep_sobol": least_ms(k3_bytes + n + bf16_w, {"bf16": chain, "f32": trace_ops}),
        "megastep_budgets_stats": least_ms(k3_bytes + n / 2 + bf16_w,
                                        {"bf16": chain, "f32": trace_ops}),
        "megastep_enclosed": least_ms(k3_bytes, {"f32": enclosed_ops}),
        "megastep_int8_sobol_budgets_stats": least_ms(k3_bytes + 1.5 * n + int8_w,
                                                   {"int8": chain, "f32": trace_ops}),
        # The stubbed chain does no products but still encodes every ray;
        # the stubbed bounce draws all 1 + L Philox groups of every ray.
        "megastep_stub_nif": least_ms(k3_bytes, {"f32": trace_ops + n * ENCODE_OPS
                                                 + (n + bounces / MAIN_SPS) * PHILOX_GROUP_OPS}),
        "megastep_stub_trace": least_ms(k3_bytes + bf16_w, {"bf16": 2 * NIF_MACS * n,
                                                            "f32": stub_ray_ops}),
        "megastep_stub_both": least_ms(k3_bytes, {"f32": stub_ray_ops}),
        "overlap_mxu": least_ms(overlap.LANES * 8 + bf16_w, {"bf16": lanes_chain}),
        "overlap_alu": least_ms(overlap.LANES * 8, {"f32": overlap.K6_ROUNDS * alu}),
        "overlap_both": least_ms(overlap.LANES * 8 + bf16_w,
                              {"bf16": lanes_chain, "f32": 28 * alu}),
    }
    # Phase 10c's 6x384 net, counted as the 6x320 rows are: K2 and K3 per
    # 1104x1000 sample, K4 per bake chunk; bf16 weights 2 B, int8 1 B.
    from ipu_path_trace_tpu_torch.models.nif import make_params, make_synthetic_nif
    from ipu_path_trace_tpu_torch.probes import wide_chain

    wide = make_params(*make_synthetic_nif(wide_chain.NET_SEED, hidden=384))
    wide_macs = sum(fi * fo for fi, fo, _ in wide.layer_plan())
    wide_chain_ops = 2 * wide_macs * escapes / MAIN_SPS
    accuracy["wide_bounds_ms"] = {
        "megastep_384_bf16": least_ms(k3_bytes + 2 * wide_macs,
                                      {"bf16": wide_chain_ops, "f32": trace_ops}),
        "megastep_384_int8": least_ms(k3_bytes + wide_macs,
                                      {"int8": wide_chain_ops, "f32": trace_ops}),
        "env_shade_384_bf16": least_ms(n * 36 + 2 * wide_macs, {"bf16": 2 * wide_macs * n}),
        "nif_apply_384_bf16": least_ms(bake_u.shape[0] * 20 + 2 * wide_macs,
                                       {"bf16": 2 * wide_macs * bake_u.shape[0]})}
    print(f"[bound] 6x384 ({wide_macs} MACs a ray): " + ", ".join(
        f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in accuracy["wide_bounds_ms"].items()), flush=True)
    # K8: features in and every output row out, the weights once; the
    # chain's real multiply-adds (padding is zero weights).
    for variant, ops in k8_ops.items():
        w_bytes = sum(w.numel() * w.element_size() for w in ops.weights)
        kind = "bf16" if variant == "bf16" else "int8" if variant.startswith("int8") else "fp8"
        io = ops.feats.numel() * ops.feats.element_size() + quant.RAYS * 4 * (
            3 if variant == "bf16" else 8)
        bounds[f"quant_probe_{variant}"] = least_ms(io + w_bytes,
                                                    {kind: 2 * NIF_MACS * quant.RAYS})
    for v, (_, state) in overlap.LOOP_VARIANTS.items():
        extra = overlap.LOOP * overlap.EXTRAS * (ALU_ROUND_OPS + 2) * overlap.LANES if state else 0
        bounds[f"overlap_{v.replace('+', '_')}"] = least_ms(
            overlap.LANES * 8 + bf16_w,
            {"bf16": overlap.LOOP * lanes_chain, "f32": overlap.LOOP * 28 * alu + extra})

    k1 = "ipu_path_trace_tpu/ops/trace_pallas.py:549"
    k2 = "ipu_path_trace_tpu/ops/nif_pallas.py:432"
    k3 = "ipu_path_trace_tpu/ops/megastep_pallas.py:433"
    k4 = "ipu_path_trace_tpu/ops/nif_pallas.py:349"
    k5 = "ipu_path_trace_tpu/ops/nif_pallas.py:257"  # the int8 chain inside K2, K3 and K4
    rows_out = [
        ("trace", "csrc/trace.cu", k1, launches["main unfused"]["trace"]),
        ("env_shade", "csrc/nif_wgmma.cuh", k2, launches["main unfused"]["env_shade"]),
        ("env_shade_int8", "csrc/nif_wgmma.cuh", k5, launches["main int8 unfused"]["env_shade"]),
        ("megastep", "csrc/megastep.cuh", k3, launches["main fused"]["megastep"]),
        ("megastep_int8", "csrc/megastep.cuh", k5, launches["main int8 fused"]["megastep"]),
        ("nif_apply", "csrc/nif_wgmma.cuh", k4, launches["main baked"]["nif_apply"]),
        ("nif_apply_int8", "csrc/nif_wgmma.cuh", k5, launches["main baked int8"]["nif_apply"]),
        # The f32 chain (--partials-type float) on tf32 wgmma, each with the
        # launches of the CLI run that drove it.
        ("env_shade_tf32", "csrc/nif_wgmma.cuh", k2, launches["f32 unfused"]["env_shade"]),
        ("megastep_tf32", "csrc/megastep.cuh", k3, launches["f32 fused"]["megastep"]),
        ("nif_apply_tf32", "csrc/nif_wgmma.cuh", k4, launches["f32 baked"]["nif_apply"]),
        # The modes of this slice, each with the launches of the CLI run
        # that drove it.
        ("trace_sobol", "csrc/trace.cu", k1, launches["sobol unfused"]["trace"]),
        ("megastep_sobol", "csrc/megastep.cuh", k3, launches["sobol fused"]["megastep"]),
        ("megastep_budgets_stats", "csrc/megastep.cuh", k3,
         launches["device film adaptive"]["megastep"]),
        ("megastep_enclosed", "csrc/megastep.cuh", k3, launches["enclosed scene"]["megastep"]),
        ("megastep_int8_sobol_budgets_stats", "csrc/megastep.cuh", k5,
         launches["int8 device film adaptive sobol"]["megastep"]),
        # This slice: K3's stubs with the launches of the --device-timing
        # run (its split runs 'nif' and the skeleton 'both'; the 'trace'
        # stub is checked and timed in phases 5c and 7 but not on the path),
        # the probes with the launches of their entry point.
        *((f"megastep_stub_{stub}", "csrc/megastep_stub.cu",
           f"ipu_path_trace_tpu/ops/megastep_pallas.py:{line}",
           launches["device timing"][f"megastep_stub_{stub}"])
          for stub, line in (("nif", 87), ("both", 238))),
        *((name, "csrc/probes.cu", "scripts/overlap_probe.py:86", launches["probes"][name])
          for name in ("overlap_mxu", "overlap_alu", "overlap_both")),
        *((name, "csrc/probes.cu", "scripts/overlap_probe2.py:82", launches["probes"][name])
          for name in launches["probes"] if name.startswith("overlap_loop")),
        # This slice: K8 with the launches of its entry point.
        *((f"quant_probe_{v}", "csrc/quant_probe.cu", "scripts/quant_probe.py:248",
           launches["quant_probe"][v]) for v in quant.VARIANTS),
    ]
    report = {"kernels": [
        {"name": nm, "route": "cuda", "source": f"ipu_path_trace_tpu_torch/{src}",
         "replaces": rep, "launches": nl, "max_abs_err": err[nm], "ms": times[nm][0],
         "plain_ms": times[nm][1], "bound_ms": bounds[nm][0], "bound_by": bounds[nm][1],
         "library_ms": library_ms.get(nm)}
        for nm, src, rep, nl in rows_out]}
    if failures:
        raise SystemExit(f"chip_smoke: failed phases: {failures}")
    (out_dir / "report.json").write_text(json.dumps(
        {**report, "nvidia_smi": smi, "build_seconds": build_s, "ptxas": ptxas,
         "main_launches": launches, "main_luminance": lum, "main_wall_s": wall,
         "main_step_s": step_s, "main_save_s": save_s, "main_wait_s": wait_s,
         "host_calls": routes, "canonical_300": canonical, "enclosed_vs_open_ms": enclosed_ms,
         "adaptive_vs_uniform_step_ms": times["adaptive_step"], "device_timing": split,
         "device_timing_unfused": unfused, "profile": prof, "probe_ms": probe_ms,
         "times_ms": times, "bounds_ms": bounds, "max_abs_err": err,
         "cublas_chain_ms": {k: v[0] for k, v in times.items() if k.startswith("cublas")},
         "quant_probe": k8_res, "quant_probe_sass_mma": k8_sass, "quality_gate": quality,
         "tf32_chain": tf32_res, "turntable": tt, "exe_manifest": manifest,
         "nif_tools": trained["numbers"], "accuracy": accuracy, "mesh": mesh_res,
         "studies": {k: studies[k] for k in ("seconds", "launches", "stub_launches")},
         "wgmma_sass_ptxas": wg_sass,
         "quality_gate_plain": quality_plain, "quality_gate_s": gate_s,
         "host_syncs": syncs, "ui_codec": codec, "ui_runs": ui_runs, "ui_parts": ui_parts,
         "bound_counts": {"escapes": escapes, "bounces": bounces,
                          "escapes_enclosed": escapes_enclosed,
                          "bounces_enclosed": bounces_enclosed}}, indent=1))
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
