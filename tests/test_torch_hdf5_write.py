"""The port's HDF5 writer (models/hdf5.py::write) and the asset writers
built on it (models/nif.py: NifWeights.save_h5, NifMetaData.save) against
h5py and the JAX package's loader and writers.

* every shipped asset, loaded by the port and saved by the port, reads
  back bit for bit - same arrays, dtypes and ``model_config`` - through
  h5py, the JAX ``NifWeights.load_h5`` and the port's own reader;
* the port's ``NifMetaData.save`` writes the same bytes as the JAX
  ``save`` for each shipped asset's metadata;
* a ragged (mixed-width, more than one SNOD of members) and a skip-less
  layer list round-trip, and the file survives h5py opening it for
  writing (the HDF5 library checks more then).

Every comparison here is exact: no tolerance.
"""

import json
from pathlib import Path

import h5py
import numpy as np
import pytest

from ipu_path_trace_tpu.models import nif as jnif
from ipu_path_trace_tpu_torch.models import hdf5, nif

ROOT = Path(__file__).resolve().parents[1]
ASSETS = sorted(p.parent.name for p in (ROOT / "assets").glob("*/converted.hdf5"))


def test_all_shipped_assets_listed():
    assert len(ASSETS) == 8, ASSETS


def _same_layers(a, b):
    assert [l.name for l in a.layers] == [l.name for l in b.layers]
    for la, lb in zip(a.layers, b.layers):
        assert la.kernel.dtype == lb.kernel.dtype and la.kernel.shape == lb.kernel.shape
        np.testing.assert_array_equal(la.kernel, lb.kernel)
        assert (la.bias is None) == (lb.bias is None)
        if la.bias is not None:
            assert la.bias.dtype == lb.bias.dtype
            np.testing.assert_array_equal(la.bias, lb.bias)
        assert (la.activation, la.dtype) == (lb.activation, lb.dtype)


def _config(path):
    with h5py.File(path, "r") as f:
        cfg = f.attrs["model_config"]
    return json.loads(cfg.decode() if isinstance(cfg, bytes) else cfg)


@pytest.mark.parametrize("name", ASSETS)
def test_shipped_asset_round_trip(tmp_path, name):
    src = ROOT / "assets" / name / "converted.hdf5"
    weights = nif.NifWeights.load_h5(str(src))
    out = tmp_path / "converted.hdf5"
    weights.save_h5(str(out))
    # h5py: the same datasets with the same dtypes, bit for bit
    with h5py.File(src, "r") as a, h5py.File(out, "r") as b:
        for l in weights.layers:
            for part in ("kernel:0", "bias:0"):
                key = f"/model_weights/{l.name}/{l.name}/{part}"
                if key not in a:
                    assert key not in b
                    continue
                x, y = a[key][()], b[key][()]
                assert x.dtype == y.dtype and x.shape == y.shape, key
                np.testing.assert_array_equal(x, y)
    # the layer list the JAX writer would have written, read back equal
    ref = tmp_path / "jax.hdf5"
    jnif.NifWeights.load_h5(str(src)).save_h5(str(ref))
    assert _config(out) == _config(ref)
    _same_layers(jnif.NifWeights.load_h5(str(out)), jnif.NifWeights.load_h5(str(src)))
    _same_layers(nif.NifWeights.load_h5(str(out)), weights)


@pytest.mark.parametrize("name", ASSETS)
def test_metadata_save_matches_jax(tmp_path, name):
    path = str(ROOT / "assets" / name / "nif_metadata.txt")
    cmd = json.load(open(path))["train_command"]
    nif.NifMetaData.load(path).save(str(tmp_path / "port.txt"), cmd)
    jnif.NifMetaData.load(path).save(str(tmp_path / "jax.txt"), cmd)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    # without a command both write the default one, whose --layer-size load scrapes
    nif.NifMetaData.load(path).save(str(tmp_path / "port0.txt"))
    jnif.NifMetaData.load(path).save(str(tmp_path / "jax0.txt"))
    assert (tmp_path / "port0.txt").read_bytes() == (tmp_path / "jax0.txt").read_bytes()
    back, orig = nif.NifMetaData.load(str(tmp_path / "port0.txt")), nif.NifMetaData.load(path)
    assert back.hidden_size == orig.hidden_size
    np.testing.assert_array_equal(back.mean, orig.mean)


def _layers(widths, skip, embed=4, seed=0, dtype="float16", bias=True):
    rng = np.random.default_rng(seed)
    feat, cur, out = 4 * embed, 4 * embed, []
    for i, w in enumerate([*widths, 3]):
        fan_in = cur + feat if skip is not None and i == skip else cur
        out.append(nif.NifLayer(
            name=f"dense_{i}" if i else "dense",
            kernel=rng.normal(size=(fan_in, w)).astype(np.float32),
            bias=rng.normal(size=(w,)).astype(np.float32) if bias or i == 0 else None,
            activation="none" if i == len(widths) else "relu", dtype=dtype))
        cur = w
    return nif.NifWeights(out)


@pytest.mark.parametrize("case", ["ragged", "no_skip"])
def test_layer_lists_round_trip(tmp_path, case):
    if case == "ragged":  # eleven mixed widths: the group spans two SNODs
        weights = _layers([40, 24, 8, 56, 16, 16, 32, 8, 24, 40, 16], skip=5, seed=1)
    else:  # no skip-concat, f32 storage, layers without bias
        weights = _layers([32, 32, 32], skip=None, seed=2, dtype="float32", bias=False)
    out = str(tmp_path / "w.hdf5")
    weights.save_h5(out)
    for loaded in (nif.NifWeights.load_h5(out), jnif.NifWeights.load_h5(out)):
        assert [l.name for l in loaded.layers] == [l.name for l in weights.layers]
        for a, b in zip(loaded.layers, weights.layers):
            store = np.float16 if b.dtype == "float16" else np.float32
            assert a.kernel.dtype == store
            np.testing.assert_array_equal(a.kernel, b.kernel.astype(store))
            assert (a.bias is None) == (b.bias is None)
            if b.bias is not None:
                np.testing.assert_array_equal(a.bias, b.bias.astype(store))
    # the HDF5 library checks more when it may write: open, add, close, reread
    with h5py.File(out, "r+") as f:
        assert sorted(f["model_weights"]) == sorted(l.name for l in weights.layers)
        f["extra"] = np.arange(3, dtype=np.float32)
    np.testing.assert_array_equal(hdf5.File(out)["/extra"], np.arange(3, dtype=np.float32))


def test_writer_datasets_and_attrs(tmp_path):
    rng = np.random.default_rng(3)
    data = {"/a/x": rng.normal(size=(3, 4)).astype(np.float32),
            "/a/b/y": rng.normal(size=(7,)).astype(np.float16),
            "/empty": np.zeros((0, 2), np.float32)}
    out = str(tmp_path / "d.h5")
    hdf5.write(out, {"note": "hello", "blank": ""}, data)
    with h5py.File(out, "r") as f:
        assert f.attrs["note"] == b"hello" and f.attrs["blank"] == b""
        for k, v in data.items():
            got = f[k][()]
            assert np.asarray(got).dtype == v.dtype and np.shape(got) == v.shape
            np.testing.assert_array_equal(got, v)
    r = hdf5.File(out)
    assert r.attrs == {"note": "hello", "blank": ""}
    for k, v in data.items():
        np.testing.assert_array_equal(r[k], v)
    for bad in (np.arange(3), np.ones(3, np.float64)):
        with pytest.raises(ValueError, match="f16 and f32"):
            hdf5.write(out, {}, {"/i": bad})
    with pytest.raises(ValueError, match="rank 1 or more"):
        hdf5.write(out, {}, {"/s": np.ones((), np.float32)})
    with pytest.raises(ValueError, match="is a dataset"):
        hdf5.write(out, {}, {"/a": np.ones(2, np.float32), "/a/b": np.ones(2, np.float32)})
