"""Train a Neural Image Field from an equirect HDR image, in PyTorch.

Counterpart of ``ipu_path_trace_tpu/models/train_nif.py``: the same
architecture (Fourier-feature MLP, f16-stored weights), the same
encode/decode contract, data pipeline, loss and optimiser, and an assets
directory (converted.hdf5 + nif_metadata.txt) that both packages' loaders
and the reference's parsers read.

Encode contract (the inverse of the NIF decode):
    z      = log(y + eps)            (log tone map; else z = y)
    mean_c = mean(z) per channel
    max    = max|z - mean|           (scalar)
    target = (z - mean) / max        in [-1, 1]
in **BGR** channel order (the renderer flips the network's output).

Arithmetic: the products run in full f32 (the trainer turns TF32 off for
its run and restores the flag after), plain eager PyTorch with autograd
for the backward and ``torch.optim.Adam`` with optax's defaults (betas
0.9 / 0.999, eps 1e-8); ``--cosine-decay`` follows optax's
``cosine_decay_schedule(lr, epochs * steps_per_epoch, alpha=0.01)``, lr(0)
on the first step.  The initial weights are He-normal from a CPU
``torch.Generator`` seeded by ``seed`` (the same on every device) and the
batch indices come from ``torch.randint`` with a generator of the same
seed on the trainer's device.  ``torch.Generator`` cannot replay
``jax.random``, so an asset trained here matches one trained by the JAX
package only statistically.

    python -m ipu_path_trace_tpu_torch.models.train_nif <image.exr | synth:...> <out_dir>
        [--layer-size 320 | --layer-sizes 256,128,...] [--layer-count 6]
        [--embedding-dimension 12] [--skip-layer 3] [--epochs N]
        [--batch-size 16384] [--train-samples N] [--learning-rate 1e-3]
        [--cosine-decay] [--seed 0] [--device cuda|cpu]

The default device is ``cuda``; without CUDA the CLI exits with an error
unless it is given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
import time
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..utils.logging import logger
from .nif import NifLayer, NifMetaData, NifWeights, fourier_features


def encode_targets(image: np.ndarray, eps: float, log_tone_map: bool):
    """RGB float image -> (bgr targets, mean(3), max) per the NIF contract,
    computed in float64 as the JAX trainer does."""
    bgr = image[..., ::-1].astype(np.float64)
    z = np.log(bgr + eps) if log_tone_map else bgr
    mean = z.reshape(-1, 3).mean(axis=0)
    max_abs = float(np.abs(z - mean).max())
    targets = ((z - mean) / max_abs).astype(np.float32)
    return targets, mean.astype(np.float32), max_abs


def layer_dims(widths: Sequence[int], embedding_dim: int,
               skip_layer: int | None) -> list[tuple[int, int]]:
    """(fan_in, fan_out) per layer: the hidden widths, the skip layer's
    input widened by the 4E features, then the 3-channel head."""
    in_dim = 4 * embedding_dim
    dims, cur = [], in_dim
    for i, w in enumerate(widths):
        dims.append((cur + in_dim if skip_layer is not None and i == skip_layer else cur, w))
        cur = w
    dims.append((cur, 3))
    return dims


class NifMLP(nn.Module):
    """The NIF network for training, batch-major: (B, 4E) features ->
    (B, 3), relu between layers, the features concatenated to the skip
    layer's input.  ``weights[i]`` is (fan_in, fan_out) as in the assets."""

    def __init__(self, kernels, biases, embedding_dim: int, skip_layer: int | None):
        super().__init__()
        self.weights = nn.ParameterList(nn.Parameter(w) for w in kernels)
        self.biases = nn.ParameterList(nn.Parameter(b) for b in biases)
        self.embedding_dim = embedding_dim
        self.skip_layer = skip_layer

    def params(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        return list(zip(self.weights, self.biases))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.params(), feats, self.skip_layer)

    def to_weights(self, names=None, activations=None, dtypes=None) -> NifWeights:
        """The trained layers as host ``NifWeights`` (f32 arrays)."""
        n = len(self.weights)
        return NifWeights([NifLayer(
            name=names[i] if names else f"dense_{i}",
            kernel=w.detach().cpu().numpy().astype(np.float32),
            bias=b.detach().cpu().numpy().astype(np.float32),
            activation=(activations[i] if activations
                        else "none" if i == n - 1 else "relu"),
            dtype=dtypes[i] if dtypes else "float16",
        ) for i, (w, b) in enumerate(self.params())])


def mlp_apply(params, feats: torch.Tensor, skip_layer: int | None) -> torch.Tensor:
    """The chain over (B, 4E) features (the JAX ``_mlp_apply``)."""
    x = feats
    for i, (w, b) in enumerate(params):
        if skip_layer is not None and i == skip_layer:
            x = torch.cat([x, feats], dim=-1)
        x = x @ w + b
        if i != len(params) - 1:
            x = torch.relu(x)
    return x


def init_params(dims, seed: int) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """He-normal kernels, zero biases, drawn on the host from a generator
    seeded by ``seed`` (the same numbers whatever the trainer's device)."""
    gen = torch.Generator().manual_seed(seed)
    kernels = [torch.randn((fan_in, fan_out), generator=gen) * math.sqrt(2.0 / fan_in)
               for fan_in, fan_out in dims]
    return kernels, [torch.zeros(fan_out) for _, fan_out in dims]


def cosine_decay(decay_steps: int, alpha: float = 0.01):
    """optax's ``cosine_decay_schedule`` as a factor of the initial lr."""
    def factor(count: int) -> float:
        c = min(count, decay_steps)
        return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps)) + alpha
    return factor


def make_optimizer(module: nn.Module, learning_rate: float, decay_steps: int | None):
    """Adam with optax's defaults and, given ``decay_steps``, the cosine
    schedule -> (optimizer, scheduler or None)."""
    opt = torch.optim.Adam(module.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    sched = (torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(decay_steps))
             if decay_steps else None)
    return opt, sched


def train_step(module: nn.Module, opt, sched, uv: torch.Tensor, y: torch.Tensor,
               forward=None) -> torch.Tensor:
    """One step on a batch of (B, 2) uv and (B, 3) targets: the mean of
    squares over B x 3, its gradient, one Adam update, the schedule's
    step.  ``forward(module, feats)`` replaces the module's own forward
    (the QAT fine-tune's fake-quantised one).  Returns the loss before the
    update, without a sync."""
    feats = fourier_features(uv[:, 0], uv[:, 1], module.embedding_dim)
    pred = module(feats) if forward is None else forward(module, feats)
    loss = torch.mean((pred - y) ** 2)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    if sched is not None:
        sched.step()
    return loss.detach()


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the products of this block; the old flag restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def uv_targets(image: np.ndarray, eps: float, log_tone_map: bool, device):
    """The training lattice uv = (row / H, col / W) and the encoded
    targets, flattened, on ``device`` -> (uv, targets, mean, max)."""
    h, w = image.shape[:2]
    targets, mean, max_abs = encode_targets(image, eps, log_tone_map)
    rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    uv = np.stack([rows.ravel() / h, cols.ravel() / w], axis=1).astype(np.float32)
    return (torch.from_numpy(uv).to(device), torch.from_numpy(targets.reshape(-1, 3)).to(device),
            mean, max_abs)


def check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_nif: CUDA is not available; --device cpu trains on the CPU")
    return device


def run_steps(module, opt, sched, uv, targets, *, epochs: int, steps_per_epoch: int,
              batch_size: int, seed: int, forward=None, record: dict | None = None) -> float:
    """The training loop: ``epochs * steps_per_epoch`` steps on batches
    drawn by ``torch.randint`` on the data's device (a generator seeded by
    ``seed``), TF32 off.  ``record`` gets each step's loss ("losses") and,
    timed by CUDA events on the card or the host clock on the CPU, its
    milliseconds ("step_ms").  The loss is logged at 20 epochs of the run
    and the last (each read is a sync).  Returns the last step's loss."""
    dev = uv.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = uv.shape[0]
    cuda = dev.type == "cuda"
    losses, marks = [], []
    loss = None
    log_every = max(1, epochs // 20)
    with exact_f32():
        for epoch in range(epochs):
            for _ in range(steps_per_epoch):
                if record is not None:
                    if cuda:
                        marks.append(torch.cuda.Event(enable_timing=True))
                        marks[-1].record()
                    else:
                        marks.append(time.perf_counter())
                idx = torch.randint(0, n, (batch_size,), generator=gen, device=dev)
                loss = train_step(module, opt, sched, uv[idx], targets[idx], forward)
                if record is not None:
                    losses.append(loss)
            if (epoch + 1) % log_every == 0 or epoch + 1 == epochs:
                logger().info("epoch %d/%d loss %.5f", epoch + 1, epochs, float(loss))
        if record is not None and marks:
            if cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
                torch.cuda.synchronize(dev)
                ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
            else:
                marks.append(time.perf_counter())
                ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
            record["step_ms"] = ms
            record["losses"] = torch.stack(losses).cpu().tolist()
    return float("nan") if loss is None else float(loss)


def train_nif(
    image: np.ndarray,
    *,
    layer_size: int | Sequence[int] = 320,
    layer_count: int = 6,
    embedding_dim: int = 12,
    skip_layer: int | None = 3,
    epochs: int = 10,
    batch_size: int = 16384,
    train_samples: int | None = None,
    learning_rate: float = 1e-3,
    cosine_decay: bool = False,
    eps: float = 1e-8,
    log_tone_map: bool = True,
    seed: int = 0,
    name: str = "trained",
    device="cuda",
    record: dict | None = None,
) -> tuple[NifWeights, NifMetaData, float]:
    """Train and return (weights, metadata, final_loss).  One "epoch"
    visits train_samples pixels (default: every pixel once)."""
    device = check_device(device)
    h, w = image.shape[:2]
    uv, targets, mean, max_abs = uv_targets(image, eps, log_tone_map, device)
    train_samples = train_samples or uv.shape[0]
    widths = ([layer_size] * layer_count if isinstance(layer_size, int) else list(layer_size))
    if len(widths) != layer_count:
        raise ValueError(f"need {layer_count} layer sizes, got {widths}")
    if skip_layer is not None and not (0 <= skip_layer < layer_count):
        raise ValueError(
            f"skip_layer={skip_layer} must be a hidden-layer index "
            f"(< layer_count={layer_count}) or None")
    kernels, biases = init_params(layer_dims(widths, embedding_dim, skip_layer), seed)
    module = NifMLP(kernels, biases, embedding_dim, skip_layer).to(device)
    steps_per_epoch = max(1, train_samples // batch_size)
    opt, sched = make_optimizer(module, learning_rate,
                                epochs * steps_per_epoch if cosine_decay else None)
    t0 = time.monotonic()
    loss = run_steps(module, opt, sched, uv, targets, epochs=epochs,
                     steps_per_epoch=steps_per_epoch, batch_size=batch_size, seed=seed,
                     record=record)
    logger().info("Training finished in %.1fs", time.monotonic() - t0)
    meta = NifMetaData(
        embedding_dimension=embedding_dim,
        name=name,
        image_shape=(h, w, 3),
        eps=eps,
        log_tone_map=log_tone_map,
        max=max_abs,
        mean=(mean - eps) if log_tone_map else mean,  # folded like the loader
        hidden_size=widths[0],
    )
    return module.to_weights(), meta, loss


def save_assets(out_dir: str, weights: NifWeights, meta: NifMetaData, train_command) -> None:
    os.makedirs(out_dir, exist_ok=True)
    weights.save_h5(os.path.join(out_dir, "converted.hdf5"))
    meta.save(os.path.join(out_dir, "nif_metadata.txt"), train_command)
    logger().info("Wrote NIF assets to %s", out_dir)


def build_parser() -> argparse.ArgumentParser:
    """The trainer CLI: the JAX trainer's flags and defaults, plus --device."""
    p = argparse.ArgumentParser(prog="train_nif")
    p.add_argument("input", help="equirect HDR image (.exr) or a synth: pseudo-path")
    p.add_argument("out_dir", help="output assets directory")
    p.add_argument("--layer-size", type=int, default=320)
    p.add_argument("--layer-sizes", type=str, default=None,
                   help="comma-separated per-layer widths (overrides --layer-size)")
    p.add_argument("--layer-count", type=int, default=6)
    p.add_argument("--embedding-dimension", type=int, default=12)
    p.add_argument("--skip-layer", type=int, default=3,
                   help="hidden-layer index of the input skip-concat "
                        "(canonical NIFs skip at 3); -1 disables it")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=16384)
    p.add_argument("--train-samples", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--cosine-decay", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'; never falls back to the CPU")
    return p


def train_command(args: argparse.Namespace) -> list[str]:
    """A replayable command: it parses through both packages' parsers to
    the same namespace and names every knob that shaped the weights.
    ``--layer-size`` stays for uniform widths (the loaders scrape it);
    ``--device`` is left out (it does not shape the weights)."""
    cmd = ["python", "-m", "ipu_path_trace_tpu_torch.models.train_nif",
           args.input, args.out_dir, "--layer-count", str(args.layer_count)]
    if args.layer_sizes:
        cmd += ["--layer-sizes", args.layer_sizes]
    else:
        cmd += ["--layer-size", str(args.layer_size)]
    cmd += ["--embedding-dimension", str(args.embedding_dimension),
            "--skip-layer", str(args.skip_layer),
            "--epochs", str(args.epochs),
            "--batch-size", str(args.batch_size),
            "--learning-rate", str(args.learning_rate),
            "--seed", str(args.seed)]
    if args.train_samples is not None:
        cmd += ["--train-samples", str(args.train_samples)]
    if args.cosine_decay:
        cmd += ["--cosine-decay"]
    return cmd


def run(args: argparse.Namespace, img, record: dict | None = None) -> float:
    """Train on ``img`` as the parsed command ``args`` says, write the
    assets to ``args.out_dir`` with the replayable command, and return
    the final loss."""
    sizes: int | Sequence[int] = args.layer_size
    if args.layer_sizes:
        sizes = [int(t) for t in args.layer_sizes.split(",")]
        args.layer_count = len(sizes)
    weights, meta, loss = train_nif(
        img,
        layer_size=sizes,
        layer_count=args.layer_count,
        embedding_dim=args.embedding_dimension,
        skip_layer=None if args.skip_layer < 0 else args.skip_layer,
        epochs=args.epochs,
        batch_size=args.batch_size,
        train_samples=args.train_samples,
        learning_rate=args.learning_rate,
        cosine_decay=args.cosine_decay,
        seed=args.seed,
        # a synth: pseudo-path names itself; a file, its absolute path
        name=args.input if args.input.startswith("synth:") else os.path.abspath(args.input),
        device=args.device,
        record=record,
    )
    save_assets(args.out_dir, weights, meta, train_command(args))
    return loss


def main(argv=None, record: dict | None = None) -> int:
    args = build_parser().parse_args(argv)
    check_device(args.device)

    from ..film.imageio import load_hdr_image
    from .synth_env import resolve_synth

    img = resolve_synth(args.input)
    if img is None:
        img = load_hdr_image(args.input)
    loss = run(args, img, record)
    print(f"final loss: {loss:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
