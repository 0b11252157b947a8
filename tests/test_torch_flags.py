"""The reference CLI flags the port settles for good (runtime/cli.py).

``--model`` is ``--device cpu``; ``--defer-attach``, ``--codelet-path``
and ``--available-memory-proportion`` are accepted and ignored with a
debug line; ``--no-use-pallas`` and ``--rng-impl`` other than ``auto``
are rejected with the reason; ``--partials-type float`` loads the NIF in
f32; ``--compile-only``, ``--cache-dir``, ``--save-exe`` and
``--load-exe`` act on the kernel library (ops/_lib.py), which the CPU
cannot build: its build is replaced here by a file standing for it, and
the manifest logic, the digest check and the CLI's flow are what is
held.  Only ``--ipus`` and ``--mesh-shape`` stay unported
(tests/test_torch_app.py::test_cli_unported_flags_name_their_roadmap_item).
"""

import json
import logging

import pytest

from ipu_path_trace_tpu_torch.ops import _lib
from ipu_path_trace_tpu_torch.runtime import cli, native

ARGV = ["-o", "x.png", "--assets", "constant:1,1,1", "-w", "4", "-H", "4", "-s", "1",
        "--samples-per-step", "1"]


@pytest.fixture
def library_state(monkeypatch, tmp_path):
    """The kernel library's overrides restored after the test, and its
    build replaced by a file (the CPU has no nvcc)."""
    monkeypatch.setattr(_lib, "_OVERRIDES", dict(_lib._OVERRIDES))
    fake = tmp_path / "built" / "libpt_kernels_fake.so"
    fake.parent.mkdir()
    fake.write_bytes(b"\x7fELF stands for the kernel library")
    monkeypatch.setattr(_lib, "build", lambda: fake)
    monkeypatch.setattr(native, "library", lambda: None)
    monkeypatch.setattr(native, "build", lambda: tmp_path / "libpt_host_fake.so")
    return fake


def _settled_partials(tmp_path, capsys):
    cfg = cli.parse_config([*ARGV, "--partials-type", "float", "--device", "cpu"])
    assert cfg.partials_type == "float"
    assert cli.parse_config([*ARGV, "--device", "cpu"]).partials_type == "half"


def _settled_rng_impl(tmp_path, capsys):
    with pytest.raises(ValueError, match="Philox"):
        cli.parse_config([*ARGV, "--rng-impl", "rbg"])
    assert cli.main([*ARGV, "--rng-impl", "rbg", "--device", "cpu"]) == 2
    assert "only 'auto'" in capsys.readouterr().err


def _settled_cache_dir(tmp_path, capsys):
    cfg = cli.parse_config([*ARGV, "--cache-dir", str(tmp_path / "c")])
    assert cfg.cache_dir == str(tmp_path / "c")
    _lib.configure(cfg.cache_dir)
    assert _lib.build_dir() == tmp_path / "c"
    _lib.configure()
    assert _lib.build_dir().parts[-2:] == ("build", "kernels")


def _settled_compile_only(tmp_path, capsys):
    out = tmp_path / "never.png"
    argv = [*ARGV, "--compile-only", "--device", "cpu"]
    argv[argv.index("-o") + 1] = str(out)
    assert cli.main(argv) == 0
    assert capsys.readouterr().out.strip().endswith("libpt_kernels_fake.so")
    assert not out.exists()  # exits before any render


def _settled_no_use_pallas(tmp_path, capsys):
    with pytest.raises(ValueError, match="--device cpu"):
        cli.parse_config([*ARGV, "--no-use-pallas"])
    assert cli.parse_config([*ARGV, "--use-pallas"]).device == "cuda"


SETTLED = {"partials-type float": _settled_partials, "rng-impl rbg": _settled_rng_impl,
           "cache-dir": _settled_cache_dir, "compile-only": _settled_compile_only,
           "no-use-pallas": _settled_no_use_pallas}


@pytest.mark.parametrize("flag", SETTLED)
def test_settled_reference_flags(tmp_path, capsys, library_state, flag):
    """The five flags that raised as unported until the f32 chain and the
    kernel-library flags landed, each with its behaviour now."""
    SETTLED[flag](tmp_path, capsys)


def test_model_is_device_cpu(tmp_path, capsys):
    assert cli.parse_config([*ARGV, "--model"]).device == "cpu"
    assert cli.parse_config([*ARGV, "--model", "--device", "cpu"]).device == "cpu"
    assert cli.parse_config(ARGV).device == "cuda"
    with pytest.raises(ValueError, match="--model"):
        cli.parse_config([*ARGV, "--model", "--device", "cuda"])
    argv = [*ARGV, "--model"]
    argv[argv.index("-o") + 1] = str(tmp_path / "m.png")
    assert cli.main(argv) == 0  # renders on the CPU, no CUDA asked for
    assert (tmp_path / "m.png").exists()


@pytest.mark.parametrize("flag", [["--defer-attach"], ["--codelet-path", "/nowhere"],
                                  ["--available-memory-proportion", "0.3"]])
def test_ignored_flags_are_accepted_and_logged(tmp_path, caplog, flag):
    base = [*ARGV, "--device", "cpu"]
    assert cli.parse_config([*base, *flag]) == cli.parse_config(base)
    assert [f for f, _ in cli.ignored_flags([*base, *flag])] == [flag[0]]
    assert cli.ignored_flags(base) == []
    base[base.index("-o") + 1] = str(tmp_path / "i.png")
    with caplog.at_level(logging.DEBUG, logger="ipu_path_trace_tpu_torch.runtime.cli"):
        assert cli.main([*base, *flag, "--log-level", "debug"]) == 0
    lines = [r.getMessage() for r in caplog.records if r.name.endswith("runtime.cli")]
    assert any(ln.startswith(f"{flag[0]} is accepted for parity and ignored") for ln in lines)


def test_only_multi_gpu_flags_stay_unported():
    """The multi-GPU flags are ported too (parallel/mesh.py): no reference
    flag is left unported, and every one is in the help."""
    assert cli._UNPORTED == []
    help_text = cli.build_parser().format_help()
    for flag in ("--model", "--partials-type", "--use-pallas", "--rng-impl", "--compile-only",
                 "--cache-dir", "--save-exe", "--load-exe", "--defer-attach", "--codelet-path",
                 "--available-memory-proportion", "--ipus", "--mesh-shape"):
        assert flag in help_text, flag
    assert "accepted for parity and ignored" in help_text


def test_save_exe_then_load_exe(tmp_path, library_state):
    """--save-exe copies the library beside a manifest of the source digest,
    the nvcc flags and the GPU; --load-exe takes it while the digest is the
    sources', and refuses a stale or missing one without rebuilding."""
    name = str(tmp_path / "exe" / "tracer")
    saved = _lib.save_exe(name)
    assert saved.read_bytes() == library_state.read_bytes()
    manifest = json.loads((tmp_path / "exe" / "tracer.json").read_text())
    assert manifest["digest"] == _lib._digest()
    assert manifest["nvcc_flags"] == list(_lib.NVCC_FLAGS) and "gpu" in manifest
    _lib.configure(load_exe=name)
    assert _lib.library_path() == saved
    _lib.configure()
    manifest["digest"] = "0" * 16
    (tmp_path / "exe" / "tracer.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="rebuild it with --save-exe"):
        _lib.configure(load_exe=name)
    with pytest.raises(ValueError, match="no readable manifest"):
        _lib.configure(load_exe=str(tmp_path / "none"))
    assert _lib._OVERRIDES["load_exe"] is None


def test_cli_save_exe_and_load_exe(tmp_path, capsys, library_state):
    name = str(tmp_path / "tracer")
    argv = [*ARGV, "--device", "cpu", "--compile-only", "--save-exe", name]
    assert cli.main(argv) == 0
    assert (tmp_path / "tracer.so").exists() and (tmp_path / "tracer.json").exists()
    capsys.readouterr()
    assert cli.main([*ARGV, "--device", "cpu", "--compile-only", "--load-exe", name]) == 0
    assert capsys.readouterr().out.strip() == str(tmp_path / "tracer.so")
    (tmp_path / "tracer.json").write_text(json.dumps({"digest": "stale"}))
    assert cli.main([*ARGV, "--device", "cpu", "--load-exe", name]) == 2
    assert "rebuild it with --save-exe" in capsys.readouterr().err
    assert cli.main([*ARGV, "--save-exe", name, "--load-exe", name]) == 2


def test_compile_only_without_nvcc_raises(tmp_path, monkeypatch):
    """Without the CUDA toolkit the build raises as ops/_lib.py's does."""
    monkeypatch.setattr(_lib, "_OVERRIDES", dict(_lib._OVERRIDES))
    try:
        _lib._nvcc()
    except RuntimeError:
        pass
    else:
        monkeypatch.setattr(_lib, "_nvcc", lambda: (_ for _ in ()).throw(
            RuntimeError("nvcc not found: the port's CUDA kernels are built at first use and "
                         "need the CUDA toolkit")))
    monkeypatch.setattr(_lib, "build_dir", lambda: tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cli.main([*ARGV, "--device", "cpu", "--compile-only"])
