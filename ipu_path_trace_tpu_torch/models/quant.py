"""Post-training int8 quantization of the NIF chain, and its plain forward.

Counterpart of ``ipu_path_trace_tpu/models/quant.py``: the quantiser,
its plain forward, and the QAT fine-tune (``fake_quant_apply``,
``qat_finetune``; the end of this module).  The scheme is the reference's:

* weights: per-output-channel symmetric int8, sw[oc] = absmax(w[:, oc]) / 127;
* Fourier features: exactly in [-1, 1], constant scale 1/127;
* hidden activations: post-ReLU, per-layer asymmetric grids [0, a_i] onto
  [-128, 127] (zero point -128 folded into the next layer's bias), with
  a_i from a calibration pass over a uniform (u, v) lattice or from a
  QAT asset's ``quant_amax.json``;
* the skip layer runs as two dots (trunk x activation scale, features x
  1/127); the head's output and the decode stay f32.

Layer i:  acc = int8 w_i . int8 x_i (int32);  y = acc * mults[i]
(+ accf * mult_skip) + biases[i] (f32);  hidden layers then ReLU and
x_{i+1} = clip(rint(y * inv_next[i]) - 128, -128, 127).

The plain forward computes the integer dots as float32 matrix products of
integer-valued tensors.  Every product is at most 127 * 128 in magnitude,
so every partial sum is an integer below 2^24 - exact in f32, in any
order - while K * 127 * 128 < 2^24 (K <= 1031, asserted).  The CUDA
kernels (csrc/nif_wgmma.cuh::ChainInt8) run the same arithmetic on the
int8 tensor cores, so given the same int8 features every integer and
every requantised code agrees.  The f32 encode is the port's direct
sin/cos (models/nif.fourier_features), not the TPU kernel's double-angle
recurrence, so a feature next to a rounding tie may take a neighbouring
code: the reference's own int8 parity budgets apply.
"""

from __future__ import annotations

import numpy as np
import torch

from .nif import NifMetaData, NifModel, NifWeights, fourier_features

QMAX = 127.0  # symmetric grid: weights and Fourier features
AQMAX = 255.0  # asymmetric activation grid: [0, a_i] -> [-128, 127]
ZP = 128.0  # activation zero point (folded into the next bias)
MAX_EXACT_K = 1031  # largest contraction with K * 127 * 128 < 2^24


class QuantNifModel(NifModel):
    """The int8 NIF: per layer an int8 kernel (in, out), an f32 bias
    (zero-point fold included) and f32 accumulator multipliers (out,);
    the skip layer's feature-dot multipliers ``mult_skip`` (zeros when
    the net has no skip); the requant steps ``inv_next`` (L,) = 255 / a_i
    (last entry unused, 1); and the f32 decode constants."""

    def __init__(self, kernels, biases, mults, mult_skip, inv_next, max_value: float,
                 mean, log_tone_map: bool):
        super().__init__(kernels, biases, max_value, mean, log_tone_map)
        if len(mults) != self.num_layers:
            raise ValueError("need one multiplier vector per layer")
        for i, m in enumerate(mults):
            self.register_buffer(f"mult_{i}", m.to(torch.float32).contiguous())
        self.register_buffer("mult_skip", mult_skip.to(torch.float32).contiguous())
        self.register_buffer("inv_next", inv_next.to(torch.float32).contiguous())

    @property
    def mults(self) -> list[torch.Tensor]:
        return [getattr(self, f"mult_{i}") for i in range(self.num_layers)]

    @property
    def skip_layer(self) -> int:
        """Index of the skip-concat layer (from the shapes); -1 = none."""
        return next((i for i, (_, _, s) in enumerate(self.layer_plan()) if s), -1)

    def forward(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return nif_apply_quant(self, u, v)


def _f32_chain_activations(weights: NifWeights, feats: np.ndarray,
                           chunk: int = 1 << 15) -> list[float]:
    """f32 forward over (P, 4E) features -> the per-hidden-layer absmax
    of the post-ReLU outputs (the activation calibration)."""
    params = [(torch.from_numpy(l.kernel.astype(np.float32)),
               torch.from_numpy((l.bias if l.bias is not None
                                 else np.zeros(l.kernel.shape[1])).astype(np.float32)))
              for l in weights.layers]
    amax = np.zeros((len(params) - 1,), np.float64)
    for lo in range(0, feats.shape[0], chunk):
        f = torch.from_numpy(np.ascontiguousarray(feats[lo:lo + chunk], np.float32))
        x = f
        for i, (w, b) in enumerate(params):
            if x.shape[-1] != w.shape[0]:
                x = torch.cat([x, f], dim=-1)
            x = x @ w + b
            if i < len(params) - 1:
                x = torch.relu(x)
                amax[i] = max(amax[i], float(x.abs().max()))
    return [max(1e-6, float(a)) for a in amax]


def calibration_features(embedding_dim: int, grid=(256, 512)) -> np.ndarray:
    """(P, 4E) f32 Fourier features over the uniform lattice
    u = (i + 0.5) / h, v = (j + 0.5) / w, with the port's encode (the one
    its kernels quantise)."""
    h, w = grid
    u = (torch.arange(h, dtype=torch.float32) + 0.5) / h
    v = (torch.arange(w, dtype=torch.float32) + 0.5) / w
    uu, vv = torch.meshgrid(u, v, indexing="ij")
    return fourier_features(uu.reshape(-1), vv.reshape(-1), embedding_dim).numpy()


def quantize_nif(weights: NifWeights, meta: NifMetaData, grid=(256, 512), amax=None,
                 device="cpu") -> QuantNifModel:
    """PTQ of a loaded NIF (module docstring); ``amax`` (one float per
    hidden layer) skips the lattice calibration, as a QAT asset's
    ``quant_amax.json`` does."""
    if amax is None:
        amax = _f32_chain_activations(
            weights, calibration_features(meta.embedding_dimension, grid))
    nl = len(weights.layers)
    if len(amax) != nl - 1:
        raise ValueError(f"need {nl - 1} activation grids, got {len(amax)}")
    kernels, biases, mults = [], [], []
    mult_skip = None
    inv_next = np.ones((nl,), np.float32)
    prev_w = weights.layers[0].kernel.shape[0]  # = 4E
    for i, l in enumerate(weights.layers):
        w = l.kernel.astype(np.float32)  # (in, out)
        sw = np.maximum(np.abs(w).max(axis=0), 1e-12) / QMAX  # (out,)
        q = np.clip(np.round(w / sw), -QMAX, QMAX).astype(np.int8)
        b = (l.bias if l.bias is not None else np.zeros(w.shape[1])).astype(np.float32)
        in_scale = (1.0 / QMAX) if i == 0 else amax[i - 1] / AQMAX
        mult = (sw * in_scale).astype(np.float32)
        if w.shape[0] != prev_w:  # skip-concat layer: features at scale 1/127
            mult_skip = (sw * (1.0 / QMAX)).astype(np.float32)
        if i > 0:  # zero-point fold over the trunk rows (feature rows: zero point 0)
            ksum = q[:prev_w, :].astype(np.float32).sum(axis=0)
            b = b + mult * np.float32(ZP) * ksum
        if i < nl - 1:
            inv_next[i] = AQMAX / amax[i]
        kernels.append(torch.from_numpy(q))
        biases.append(torch.from_numpy(b))
        mults.append(torch.from_numpy(mult))
        prev_w = w.shape[1]
    if mult_skip is None:
        mult_skip = np.zeros_like(mults[0].numpy())
    return QuantNifModel(kernels, biases, mults, torch.from_numpy(mult_skip),
                         torch.from_numpy(inv_next), meta.max, meta.mean,
                         meta.log_tone_map).to(device)


def quant_params_from_jax(qparams, device="cpu") -> QuantNifModel:
    """The reference's ``QuantNifParams`` (arrays readable by numpy) as a
    QuantNifModel holding the same numbers."""

    def f32(a):
        return torch.from_numpy(np.asarray(a).astype(np.float32))

    return QuantNifModel(
        [torch.from_numpy(np.asarray(k).astype(np.int8)) for k in qparams.kernels],
        [f32(b) for b in qparams.biases],
        [f32(m) for m in qparams.mults],
        f32(qparams.mult_skip), f32(qparams.inv_next),
        float(np.asarray(qparams.max)), np.asarray(qparams.mean, np.float32),
        bool(np.asarray(qparams.log_tone_map)),
    ).to(device)


def _int_dot(w_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8 (out, K) and int8-valued (K, B) as
    integer-valued f32 (module docstring)."""
    if w_t.shape[1] > MAX_EXACT_K:
        raise ValueError(f"contraction of {w_t.shape[1]} > {MAX_EXACT_K}: the f32 "
                         "integer dot would no longer be exact")
    if w_t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on: the f32 integer dot would round")
    return w_t.float() @ x.float()


def quant_dots(x: torch.Tensor, feats: torch.Tensor, w_t: torch.Tensor,
               is_skip: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The layer's int32 accumulators: (trunk dot, feature dot or None)."""
    if not is_skip:
        return _int_dot(w_t, x).to(torch.int32), None
    trunk = w_t.shape[1] - feats.shape[0]
    return (_int_dot(w_t[:, :trunk], x).to(torch.int32),
            _int_dot(w_t[:, trunk:], feats).to(torch.int32))


def quant_layer_t(x, feats, w_t, bias_c, mult_c, mult_skip_c, inv_next: float,
                  is_last: bool, is_skip: bool) -> torch.Tensor:
    """One int8 Dense stage, feature-major: ``x`` int8 (in, B), ``feats``
    int8 (4E, B), ``w_t`` int8 (out, in), (out, 1) f32 bias/multipliers.
    Returns f32 (out, B) for the head, int8 codes for hidden layers.  The
    f32 operations run in the reference's order."""
    acc, accf = quant_dots(x, feats, w_t, is_skip)
    y = acc.float() * mult_c
    if is_skip:
        y = y + accf.float() * mult_skip_c
    y = y + bias_c
    if is_last:
        return y
    y = torch.relu(y)
    q = torch.clamp(torch.round(y * inv_next) - ZP, -128.0, 127.0)
    return q.to(torch.int8)


def quantize_features(feats_f: torch.Tensor) -> torch.Tensor:
    """f32 features in [-1, 1] -> int8 codes clip(rint(f * 127), +-127)."""
    return torch.clamp(torch.round(feats_f * QMAX), -QMAX, QMAX).to(torch.int8)


def quant_mlp_t(model: QuantNifModel, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Encode -> int8 chain -> (3, B) f32 head output in network channel
    order, before the decode."""
    feats = quantize_features(fourier_features(u, v, model.embedding_dim)).t()
    skip = model.skip_layer
    inv_next = model.inv_next.tolist()
    x = feats
    last = model.num_layers - 1
    for i, (w, b, m) in enumerate(zip(model.kernels, model.biases, model.mults)):
        x = quant_layer_t(x, feats, w.t(), b[:, None], m[:, None], model.mult_skip[:, None],
                          inv_next[i], is_last=i == last, is_skip=i == skip)
    return x


def nif_apply_quant(model: QuantNifModel, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """int8 NIF inference -> (P, 3) f32 decoded radiance, network order."""
    y = quant_mlp_t(model, u, v).t() * model.max + torch.tensor(model.mean, device=u.device)
    return torch.exp(y) if model.log_tone_map else y


# ------------------------------------------------------------------------
# Quantisation-aware fine-tuning (QAT)
# ------------------------------------------------------------------------
#
# PTQ alone loses quality on class; QAT re-fits the trained weights
# THROUGH the inference quantiser with straight-through-estimator
# gradients.  The activation grids stay fixed at the pretrained
# calibration, and the same amax is handed to quantize_nif, so training
# and inference quantise identically.


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: forward q, the gradient of identity."""
    return x + (q - x).detach()


def fake_quant_apply(params, feats: torch.Tensor, skip_layer: int | None, amax) -> torch.Tensor:
    """The training-layout forward ((B, in) batch-major, as the trainer's
    models/train_nif.mlp_apply) with every inference quantisation point
    fake-quantised under the STE: the features on the constant 1/127
    grid; the weights per-output-channel symmetric int8, their scales from
    the live weights (detached); the post-ReLU activations on the fixed
    per-layer grids [0, a_i] of 256 levels.  ``params`` is a list of
    (w, b) tensors, ``amax`` one float per hidden layer.  The head's output
    stays f32."""
    feats = _ste(feats, torch.round(torch.clamp(feats, -1, 1) * QMAX) / QMAX)
    x = feats
    nl = len(params)
    for i, (w, b) in enumerate(params):
        sw = torch.clamp(w.detach().abs().amax(dim=0), min=1e-12) / QMAX
        wq = _ste(w, torch.clamp(torch.round(w / sw), -QMAX, QMAX) * sw)
        if skip_layer is not None and i == skip_layer:
            x = torch.cat([x, feats], dim=-1)
        x = x @ wq + b
        if i != nl - 1:
            x = torch.relu(x)
            # round(x * inv) in f32, the inference requant's form: x / step
            # rounds differently at ties.
            inv = float(np.float32(AQMAX / amax[i]))
            step = float(np.float32(amax[i] / AQMAX))
            x = _ste(x, torch.clamp(torch.round(x * inv), 0, AQMAX) * step)
    return x


def skip_from_shapes(weights: NifWeights) -> int | None:
    """The skip-concat layer's index, found from the layer shapes."""
    skip, prev = None, weights.layers[0].kernel.shape[0]
    for i, l in enumerate(weights.layers[1:], start=1):
        if l.kernel.shape[0] != prev:
            skip = i
        prev = l.kernel.shape[1]
    return skip


def qat_finetune(weights: NifWeights, meta: NifMetaData, image: np.ndarray, *,
                 epochs: int = 2000, batch_size: int = 16384,
                 train_samples: int | None = None, learning_rate: float = 2e-4,
                 calib_grid=(256, 512), seed: int = 0, device="cuda",
                 record: dict | None = None):
    """Fine-tune a trained NIF through the int8 fake-quant forward: the
    trainer's data pipeline and loss (models/train_nif.py), from the
    trained weights, Adam with a cosine-decayed low lr, TF32 off.  The
    activation grids are the f32 chain's lattice calibration
    (``_f32_chain_activations``), fixed.  Returns (new NifWeights, amax
    tuple, final loss); pass the same amax to ``quantize_nif``.
    ``record`` gets the per-step losses and milliseconds (as
    train_nif.run_steps)."""
    from .train_nif import NifMLP, check_device, make_optimizer, run_steps, uv_targets

    device = check_device(device)
    amax = tuple(_f32_chain_activations(
        weights, calibration_features(meta.embedding_dimension, calib_grid)))
    uv, targets, _, _ = uv_targets(image, meta.eps, meta.log_tone_map, device)
    train_samples = train_samples or uv.shape[0]
    skip = skip_from_shapes(weights)
    module = NifMLP(
        [torch.from_numpy(l.kernel.astype(np.float32)) for l in weights.layers],
        [torch.from_numpy((l.bias if l.bias is not None
                           else np.zeros(l.kernel.shape[1])).astype(np.float32))
         for l in weights.layers],
        meta.embedding_dimension, skip).to(device)
    steps_per_epoch = max(1, train_samples // batch_size)
    opt, sched = make_optimizer(module, learning_rate, epochs * steps_per_epoch)
    loss = run_steps(module, opt, sched, uv, targets, epochs=epochs,
                     steps_per_epoch=steps_per_epoch, batch_size=batch_size, seed=seed,
                     forward=lambda m, f: fake_quant_apply(m.params(), f, skip, amax),
                     record=record)
    new = module.to_weights(names=[l.name for l in weights.layers],
                            activations=[l.activation for l in weights.layers],
                            dtypes=[l.dtype for l in weights.layers])
    return new, amax, loss
