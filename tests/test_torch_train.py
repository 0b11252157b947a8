"""The port's NIF trainer (models/train_nif.py) against the JAX package's
(ipu_path_trace_tpu/models/train_nif.py), on the CPU.

Tolerances, each stated where it is used:
* ``encode_targets``: bit for bit (both compute in float64 with numpy);
* one step from the same params and batch: the loss to 1e-6 relative,
  each layer's gradient to 1e-5 of its max |g| (the two sin/cos and
  product implementations round differently);
* Adam with the cosine schedule from the same gradients: each parameter
  to 2e-5 of the learning rate and one ulp of itself per step (optax
  computes its bias correction 1 - 0.999^t in f32, which cancels to about
  1e-5 relative error, torch in f64; the final add rounds once more);
* 20 steps from JAX's own initial params and ``jax.random.randint``
  indices: the loss to 1e-4 relative at every step;
* the JAX trainer test's settings (tests/test_nif_train.py): loss < 0.01
  and median reconstruct error < 0.15 in both packages.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ipu_path_trace_tpu.models import nif as jnif
from ipu_path_trace_tpu.models import train_nif as jtrain
from ipu_path_trace_tpu.models.reconstruct import reconstruct_image as jreconstruct
from ipu_path_trace_tpu_torch.models import nif, synth_env, train_nif
from ipu_path_trace_tpu_torch.models.reconstruct import reconstruct_image
from ipu_path_trace_tpu_torch.probes import train_replay

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite runs several workers on the
    same cores, and the trainer's many small ops, each split over every
    core, then wait on each other (a 300-step run took 20x longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _test_image(h=32, w=64):
    """tests/test_nif_train.py's image: a smooth HDR gradient and a bright blob."""
    rows, cols = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    img = np.stack([0.2 + rows, 0.3 + 0.5 * cols, 1.5 - rows * cols], axis=-1).astype(np.float32)
    img[h // 4: h // 2, w // 4: w // 2] *= 8.0
    return img


@pytest.mark.parametrize("log_tone_map", [True, False])
def test_encode_targets_bitwise(log_tone_map):
    for img in (_test_image(), synth_env.resolve_synth("synth:urban-alley:32x64:seed7")):
        a = train_nif.encode_targets(img, 1e-8, log_tone_map)
        b = jtrain.encode_targets(img, 1e-8, log_tone_map)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]


def _jax_setup(img, widths, embed, skip, seed):
    """JAX's initial params, data and per-step loss/grad function."""
    targets, _, _ = jtrain.encode_targets(img, 1e-8, True)
    h, w = img.shape[:2]
    rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    uv = np.stack([rows.ravel() / h, cols.ravel() / w], axis=1).astype(np.float32)
    dims = train_nif.layer_dims(widths, embed, skip)
    key = jax.random.key(seed)
    key, init_key = jax.random.split(key)
    params = jtrain._init_params(init_key, dims)

    def loss_fn(params, uv_b, y_b):
        feats = jnif.fourier_features(uv_b[:, 0], uv_b[:, 1], embed)
        return jnp.mean((jtrain._mlp_apply(params, feats, skip) - y_b) ** 2)

    return key, params, uv, targets.reshape(-1, 3), jax.jit(jax.value_and_grad(loss_fn))


def _module(params, embed, skip):
    return train_nif.NifMLP([torch.from_numpy(np.array(w)) for w, _ in params],
                            [torch.from_numpy(np.array(b)) for _, b in params], embed, skip)


@pytest.mark.parametrize("skip", [1, None])
def test_one_step_loss_and_grads(skip):
    embed = 6
    _, params, uv, y, vg = _jax_setup(_test_image(), [48, 40, 32], embed, skip, 3)
    idx = np.random.default_rng(5).integers(0, uv.shape[0], 1024)
    loss_j, grads_j = vg(params, jnp.asarray(uv[idx]), jnp.asarray(y[idx]))
    module = _module(params, embed, skip)
    opt, sched = train_nif.make_optimizer(module, 1e-3, None)
    loss = train_nif.train_step(module, opt, sched, torch.from_numpy(uv[idx]),
                                torch.from_numpy(y[idx]))
    # the loss to 1e-6 relative
    assert abs(float(loss) - float(loss_j)) <= 1e-6 * abs(float(loss_j))
    # each layer's gradient to 1e-5 of its max |g|
    for (gw, gb), w, b in zip(grads_j, module.weights, module.biases):
        for g_ref, g in ((gw, w.grad), (gb, b.grad)):
            g_ref = np.asarray(g_ref)
            assert np.abs(g.numpy() - g_ref).max() <= 1e-5 * np.abs(g_ref).max()


@pytest.mark.parametrize("cosine", [True, False])
def test_adam_and_cosine_match_optax(cosine):
    rng = np.random.default_rng(11)
    shapes = [(8, 16), (16,), (16, 3)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    lr, steps = 1e-2, 6
    sched = optax.cosine_decay_schedule(lr, steps, alpha=0.01) if cosine else lr
    tx = optax.adam(sched)
    pj = [jnp.asarray(p) for p in p0]
    state = tx.init(pj)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    module = torch.nn.Module()
    module.params = torch.nn.ParameterList(params)
    opt, sch = train_nif.make_optimizer(module, lr, steps if cosine else None)
    for step in range(steps):
        grads = [(rng.normal(size=s) * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
                 for s in shapes]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state)
        pj = optax.apply_updates(pj, upd)
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        if sch is not None:
            sch.step()
        # each parameter to 2e-5 of lr and an ulp of itself per step taken
        for p, q in zip(params, pj):
            q = np.asarray(q)
            bound = (step + 1) * (2e-5 * lr + np.spacing(np.abs(q)))
            assert (np.abs(p.detach().numpy() - q) <= bound).all()
    if cosine:  # lr(0) on the first step, alpha * lr once decayed
        f = train_nif.cosine_decay(steps)
        assert f(0) == 1.0 and f(steps) == pytest.approx(0.01)
        assert opt.param_groups[0]["lr"] == pytest.approx(float(sched(steps)), rel=1e-6)


def test_twenty_steps_match_jax_trajectory():
    """JAX's own init and jax.random.randint indices (its train loop's key
    sequence) through both steps: the loss to 1e-4 relative at every step."""
    embed, skip, batch, lr, steps = 8, 2, 512, 3e-3, 20
    key, params, uv, y, vg = _jax_setup(_test_image(), [64, 48, 64], embed, skip, 4)
    tx = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.01))
    state = tx.init(params)
    module = _module(params, embed, skip)
    opt, sched = train_nif.make_optimizer(module, lr, steps)
    n = uv.shape[0]

    @jax.jit
    def update(params, state, grads):
        upd, state = tx.update(grads, state)
        return optax.apply_updates(params, upd), state

    for step in range(steps):
        key, sk = jax.random.split(key)
        idx = np.asarray(jax.random.randint(sk, (batch,), 0, n))
        loss_j, grads = vg(params, jnp.asarray(uv[idx]), jnp.asarray(y[idx]))
        params, state = update(params, state, grads)
        loss = train_nif.train_step(module, opt, sched, torch.from_numpy(uv[idx]),
                                    torch.from_numpy(y[idx]))
        assert abs(float(loss) - float(loss_j)) <= 1e-4 * float(loss_j), step


def test_train_converges_like_jax(tmp_path):
    """tests/test_nif_train.py:31-56's settings in both packages."""
    img = _test_image()
    kw = dict(layer_size=64, layer_count=3, embedding_dim=8, skip_layer=None, epochs=300,
              batch_size=2048, learning_rate=3e-3, seed=1)
    w_p, m_p, loss_p = train_nif.train_nif(img, device="cpu", **kw)
    w_j, m_j, loss_j = jtrain.train_nif(img, **kw)
    assert loss_p < 0.01 and loss_j < 0.01, (loss_p, loss_j)
    np.testing.assert_array_equal(m_p.mean, m_j.mean)
    assert m_p.max == m_j.max and m_p.hidden_size == m_j.hidden_size == 64
    out = str(tmp_path / "port")
    train_nif.save_assets(out, w_p, m_p, ["train_nif.py", "--layer-size", "64"])
    model, meta, _ = nif.load_nif_assets(out)
    assert meta.hidden_size == 64
    rec = reconstruct_image(model, img.shape[0], img.shape[1], max_batch_size=512)
    rec_j = jreconstruct(jnif.make_params(w_j, m_j), img.shape[0], img.shape[1],
                         max_batch_size=512)
    for r in (rec, rec_j):
        rel = np.abs(r - img) / (np.abs(img) + 0.1)
        assert np.median(rel) < 0.15, np.median(rel)


def _namespace(parser, argv):
    ns = vars(parser.parse_args(argv))
    ns.pop("device", None)
    return ns


def test_shipped_and_port_commands_parse_alike(tmp_path):
    seen = 0
    for meta_path in sorted(os.listdir(os.path.join(REPO, "assets"))):
        path = os.path.join(REPO, "assets", meta_path, "nif_metadata.txt")
        if not os.path.exists(path):
            continue
        cmd = json.load(open(path))["train_command"]
        if cmd[:3] != ["python", "-m", "ipu_path_trace_tpu.models.train_nif"]:
            continue
        assert _namespace(train_nif.build_parser(), cmd[3:]) == _namespace(
            jtrain.build_parser(), cmd[3:])
        seen += 1
    assert seen >= 6
    from ipu_path_trace_tpu_torch.film.imageio import write_exr

    src = str(tmp_path / "tiny.exr")
    write_exr(src, _test_image(8, 16))
    out = str(tmp_path / "cli_assets")
    assert train_nif.main([src, out, "--layer-size", "24", "--layer-count", "3",
                           "--embedding-dimension", "4", "--skip-layer", "1", "--epochs", "2",
                           "--batch-size", "64", "--seed", "7", "--cosine-decay",
                           "--train-samples", "128", "--device", "cpu"]) == 0
    cmd = json.load(open(os.path.join(out, "nif_metadata.txt")))["train_command"]
    assert cmd[:3] == ["python", "-m", "ipu_path_trace_tpu_torch.models.train_nif"]
    assert "--device" not in cmd
    ns = _namespace(train_nif.build_parser(), cmd[3:])
    assert ns == _namespace(jtrain.build_parser(), cmd[3:])
    assert (ns["input"], ns["out_dir"], ns["layer_size"], ns["skip_layer"]) == (src, out, 24, 1)
    assert ns["cosine_decay"] and ns["train_samples"] == 128 and ns["seed"] == 7
    _, meta, weights = nif.load_nif_assets(out)
    assert meta.hidden_size == 24 and weights.layers[1].kernel.shape == (24 + 16, 24)
    jmeta = jnif.NifMetaData.load(os.path.join(out, "nif_metadata.txt"))
    assert jmeta.hidden_size == 24 and jmeta.name == os.path.abspath(src)


def test_cli_needs_cuda_or_device_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["synth:urban-alley:8x16:seed1", str(tmp_path / "a"), "--layer-size", "8",
            "--layer-count", "2", "--embedding-dimension", "2", "--skip-layer", "-1",
            "--epochs", "1", "--batch-size", "32"]
    with pytest.raises(SystemExit, match="CUDA is not available"):
        train_nif.main(argv)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        train_nif.train_nif(_test_image(8, 16), layer_size=8, layer_count=2, embedding_dim=2,
                            epochs=1, batch_size=32)
    assert not os.path.exists(tmp_path / "a")
    assert train_nif.main([*argv, "--device", "cpu"]) == 0
    assert nif.NifMetaData.load(str(tmp_path / "a" / "nif_metadata.txt")).name == argv[0]


def test_tf32_off_during_steps_and_restored(monkeypatch):
    seen = []
    step = train_nif.train_step

    def spy(*a, **k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return step(*a, **k)

    monkeypatch.setattr(train_nif, "train_step", spy)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        record = {}
        train_nif.train_nif(_test_image(8, 16), layer_size=8, layer_count=2, embedding_dim=2,
                            skip_layer=None, epochs=3, batch_size=64, device="cpu",
                            record=record)
        assert seen == [False] * 6 and torch.backends.cuda.matmul.allow_tf32 is True
        assert len(record["losses"]) == len(record["step_ms"]) == 6
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_train_replay_cpu(tmp_path, capsys, monkeypatch):
    """probes/train_replay.main with the shipped recipes cut to a toy size
    (the recorded commands replaced; the probe has no cut flags): both
    seeds trained and scored, the QAT recipe's argv run through
    tools/quant_qat.main, the shipped assets scored in the same run."""
    canonical = ["python", "-m", "ipu_path_trace_tpu.models.train_nif",
                 "synth:urban-alley:32x64:seed7", "assets/urban_alley_synth_nif",
                 "--layer-count", "2", "--layer-size", "16", "--embedding-dimension", "4",
                 "--skip-layer", "-1", "--epochs", "2", "--batch-size", "256",
                 "--train-samples", "512", "--learning-rate", "0.001", "--seed", "0",
                 "--cosine-decay"]
    qat = ["python", "scripts/quant_qat.py", "--epochs", "1", "--batch-size", "256",
           "--train-samples", "512", "--lr", "0.0002", "--seed", "0", "--grid", "16x32",
           "--save-always"]
    cmds = {train_replay.CANONICAL: canonical, train_replay.INT8: qat}
    monkeypatch.setattr(train_replay, "recorded_command", cmds.__getitem__)
    monkeypatch.setattr(train_replay, "MAX_BATCH", 4096)
    out = train_replay.main(["--out", str(tmp_path), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["recipe"] == canonical[3:] and set(out["runs"]) == {"seed0", "seed1", "qat"}
    s0, s1, q = (out["runs"][k] for k in ("seed0", "seed1", "qat"))
    assert s0["steps"] == s1["steps"] == 4 and s0["first_loss"] != s1["first_loss"]
    assert q["steps"] == 2 and q["epochs"] == 1
    assert q["step_bound_ms"] == train_replay.step_bound_ms(
        nif.load_nif_assets(str(tmp_path / "qat"))[2], 256)
    for key in ("bf16_psnr_db", "int8_psnr_db"):
        assert np.isfinite(out["shipped"][key])
    assert all(np.isfinite(r[k]) for r in (s0, s1) for k in ("bf16_psnr_db", "final_loss"))
    assert np.isfinite(q["int8_psnr_db"])
    assert out["seed_spread_db"] == abs(s0["bf16_psnr_db"] - s1["bf16_psnr_db"])
    assert nif.NifMetaData.load(str(tmp_path / "seed1" / "nif_metadata.txt")).hidden_size == 16
