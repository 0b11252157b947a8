"""The port's SavedModel converter (models/convert.py) against the JAX
package's, on the fake SavedModels of tests/test_convert.py (a real
TensorBundle checkpoint written byte by byte, no TensorFlow).

Each case goes through both converters: the converted weights are equal
bit for bit (names, dtypes, arrays; no tolerance), the copied metadata
byte for byte, and a bad input raises the same error with the same
message in both.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest

from ipu_path_trace_tpu.models import convert as jconvert
from ipu_path_trace_tpu.models import nif as jnif
from ipu_path_trace_tpu_torch.models import convert, nif

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_convert import _fake_saved_model, write_bundle  # noqa: E402


def _equal_weights(a, b):
    assert [l.name for l in a.layers] == [l.name for l in b.layers]
    for la, lb in zip(a.layers, b.layers):
        assert (la.activation, la.dtype) == (lb.activation, lb.dtype)
        assert la.kernel.dtype == lb.kernel.dtype
        np.testing.assert_array_equal(la.kernel, lb.kernel)
        assert (la.bias is None) == (lb.bias is None)
        if la.bias is not None:
            assert la.bias.dtype == lb.bias.dtype
            np.testing.assert_array_equal(la.bias, lb.bias)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("tf1_names", [False, True])
def test_convert_like_jax(tmp_path, compress, tf1_names):
    model_dir, _, _ = _fake_saved_model(str(tmp_path), compress=compress, tf1_names=tf1_names)
    _equal_weights(convert.saved_model_to_weights(model_dir),
                   jconvert.saved_model_to_weights(model_dir))
    assert convert.read_tensor_bundle(os.path.join(model_dir, "variables", "variables.index")) \
        == jconvert.read_tensor_bundle(os.path.join(model_dir, "variables", "variables.index"))
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    convert.convert(model_dir, port)
    jconvert.convert(model_dir, ref)
    for load in (nif.NifWeights.load_h5, jnif.NifWeights.load_h5):
        _equal_weights(load(os.path.join(port, "converted.hdf5")),
                       load(os.path.join(ref, "converted.hdf5")))
    assert (Path(port) / "nif_metadata.txt").read_bytes() == \
        (Path(ref) / "nif_metadata.txt").read_bytes()
    nif.load_nif_assets(port)  # loadable as --assets


def test_convert_without_metadata_like_jax(tmp_path):
    model_dir, _, _ = _fake_saved_model(str(tmp_path), with_meta=False)
    for conv, name in ((convert, "port"), (jconvert, "jax")):
        conv.convert(model_dir, str(tmp_path / name))
        assert (tmp_path / name / "converted.hdf5").exists()
        assert not (tmp_path / name / "nif_metadata.txt").exists()
    _equal_weights(nif.NifWeights.load_h5(str(tmp_path / "port" / "converted.hdf5")),
                   nif.NifWeights.load_h5(str(tmp_path / "jax" / "converted.hdf5")))


def _raised(fn, *args):
    with pytest.raises(Exception) as info:
        fn(*args)
    return type(info.value), str(info.value)


def test_convert_errors_like_jax(tmp_path):
    model_dir = str(tmp_path / "conv_model")
    os.makedirs(model_dir)
    write_bundle(model_dir, {"layer_with_weights-0/kernel/.ATTRIBUTES/VARIABLE_VALUE":
                             np.zeros((3, 3, 8, 16), np.float32)})
    got = _raised(convert.saved_model_to_weights, model_dir)
    assert got == _raised(jconvert.saved_model_to_weights, model_dir)
    assert got[0] is ValueError and "rank 4" in got[1]
    missing = str(tmp_path / "nope")
    got = _raised(convert.saved_model_to_weights, missing)
    assert got == _raised(jconvert.saved_model_to_weights, missing)
    assert got[0] is FileNotFoundError


def test_convert_cli_like_jax(tmp_path, capsys):
    model_dir, _, _ = _fake_saved_model(str(tmp_path))
    assert convert.main([model_dir, str(tmp_path / "cli")]) == 0
    assert jconvert.main([model_dir, str(tmp_path / "jcli")]) == 0
    _equal_weights(nif.NifWeights.load_h5(str(tmp_path / "cli" / "converted.hdf5")),
                   nif.NifWeights.load_h5(str(tmp_path / "jcli" / "converted.hdf5")))
    meta = nif.NifMetaData.load(str(tmp_path / "cli" / "nif_metadata.txt"))
    assert meta.embedding_dimension == 4
    capsys.readouterr()
    assert convert.main([]) == jconvert.main([]) == 2
    err = capsys.readouterr().err
    assert "ipu_path_trace_tpu_torch.models.convert" in err


def test_snappy_like_jax():
    ref = b"abcdef" + b"defdef" + b"abcd"
    stream = (bytes([len(ref)]) + bytes([(6 - 1) << 2]) + b"abcdef"
              + bytes([((6 - 4) << 2) | 1, 3]) + bytes([((4 - 1) << 2) | 2]) + b"\x0c\x00")
    assert convert._snappy_decompress(stream) == jconvert._snappy_decompress(stream) == ref
