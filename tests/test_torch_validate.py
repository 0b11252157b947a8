"""probes/validate_gpu.py on the CPU: its checks with the plain versions
at 16x16 (the adaptive one at 32x16, two 256-ray budget blocks, the
smallest that can adapt), and its ``rmse`` against scripts/validate_tpu.py's.
The card runs the same checks at the script's sizes through the kernels
(chip_smoke.py, and the probe's ``main``)."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from ipu_path_trace_tpu_torch.probes import validate_gpu, validate_rmse

_SCRIPT = pathlib.Path(__file__).parent.parent / "scripts" / "validate_tpu.py"



@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the suite runs files side by side in workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _script():
    spec = importlib.util.spec_from_file_location("validate_tpu", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rmse_equals_the_script():
    script = _script()
    rng = np.random.default_rng(5)
    for shape in ((16, 16, 3), (100, 3)):
        a = rng.normal(size=shape).astype(np.float32)
        b = a + rng.normal(scale=0.1, size=shape).astype(np.float32)
        assert validate_gpu.rmse(a, b) == script.rmse(a, b)
    z = np.zeros((4, 3), np.float32)
    assert validate_gpu.rmse(z, z) == script.rmse(z, z) == 0.0


def test_checks_pass_on_the_cpu():
    """Every check of the probe, bf16, int8, f32 and Sobol among the NIF
    ones, within cross < 1.5 floor + 1e-4 on the plain versions; the
    adaptive one also passes the script's assertions on the counts."""
    torch.manual_seed(0)
    res = validate_gpu.checks(spp=16, device="cpu", nif_size=(16, 16), texture_size=(16, 16),
                              adaptive_size=(32, 16), adaptive_spp=48, adaptive_block=256)
    names = [c["name"] for c in res]
    assert [n.split(" 16x16")[0] for n in names[:5]] == [
        "nif-env synthetic bf16", "nif-env canonical bf16", "nif-env canonical int8",
        "nif-env canonical f32", "nif-env canonical bf16 sobol"]
    assert names[5].startswith("texture-env") and names[6].startswith("adaptive-vs-uniform")
    for c in res:
        assert c["pass"], c
        assert 0.0 < c["floor"] < 1.0 and np.isfinite(c["cross"])


@pytest.mark.parametrize("main", [validate_gpu.main, validate_rmse.main])
def test_probes_refuse_to_run_without_out(main, capsys):
    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu"])
    assert e.value.code == 2 and "--out" in capsys.readouterr().err
