"""The port's host runtime against the JAX package's, on the CPU.

AsyncTask, the double-buffered WorkList, the LoadBalancer's shuffle,
re-deal and clear, the Film's accumulation and tone map, and the build
of the native host runtime (runtime/native.py).  The same seeded numpy
inputs go through both packages; where the JAX package would take its
own native library, its NumPy route is forced, since that library is
built with contraction (-march=native) and its re-deal sorts unstably.
"""

import os
import stat
import subprocess
import threading

import numpy as np
import pytest

from ipu_path_trace_tpu.film import film as jfilm
from ipu_path_trace_tpu.runtime import async_task as jasync
from ipu_path_trace_tpu.runtime import native as jnative
from ipu_path_trace_tpu.runtime import worklist as jworklist
from ipu_path_trace_tpu_torch.core.records import TRACE_RECORD_DTYPE, make_worklist
from ipu_path_trace_tpu_torch.film import film
from ipu_path_trace_tpu_torch.runtime import async_task, native, worklist


@pytest.fixture
def jax_numpy_route(monkeypatch):
    """The JAX package's NumPy fallbacks, as when its library is absent."""
    monkeypatch.setattr(jnative, "_load", lambda: None)


def _records(n, width, height, seed, max_len=12):
    """``n`` records of a shuffled, padded width x height worklist
    with random sums, counts (zeros included) and tied path lengths."""
    rng = np.random.default_rng(seed)
    rec = make_worklist(width, height, padded_size=max(n, width * height))
    rng.shuffle(rec)
    rec = rec[:n].copy()
    rec["r"], rec["g"], rec["b"] = rng.uniform(0, 6, size=(3, n)).astype(np.float32)
    rec["sampleCount"] = rng.integers(0, 300, n)
    rec["pathLength"] = rng.integers(0, max_len, n)
    return rec


# --- AsyncTask -----------------------------------------------------------

@pytest.mark.parametrize("cls", [async_task.AsyncTask, jasync.AsyncTask], ids=["port", "jax"])
def test_async_task_is_single_slot(cls):
    task, gate, ran = cls(), threading.Event(), []
    task.run(lambda: (gate.wait(10), ran.append(1)))
    assert task.is_running()
    with pytest.raises(RuntimeError, match="before the previous one completed"):
        task.run(lambda: ran.append(2))
    gate.set()
    task.wait_for_completion()
    assert not task.is_running() and ran == [1]
    task.run(lambda: ran.append(3))  # the slot is free again
    task.wait_for_completion()
    assert ran == [1, 3]
    task.wait_for_completion()  # nothing in flight: a no-op


@pytest.mark.parametrize("cls", [async_task.AsyncTask, jasync.AsyncTask], ids=["port", "jax"])
def test_async_task_raises_the_error_in_the_waiter(cls):
    task = cls()

    def boom():
        raise KeyError("in the task")

    task.run(boom)
    with pytest.raises(KeyError, match="in the task"):
        task.wait_for_completion()
    task.wait_for_completion()  # raised once, then cleared
    task.run(lambda: None)
    task.wait_for_completion()


# --- WorkList and LoadBalancer -------------------------------------------

def test_worklist_swap_matches_reference():
    a, b = _records(40, 6, 5, 1), _records(40, 6, 5, 2)
    ours, ref = worklist.WorkList(40), jworklist.WorkList(40)
    for w in (ours, ref):
        w.active, w.inactive = a, b
        w.swap()
    assert ours.active is b and ours.inactive is a
    np.testing.assert_array_equal(ours.active, ref.active)
    np.testing.assert_array_equal(ours.inactive, ref.inactive)
    ours.inactive = np.zeros(0, TRACE_RECORD_DTYPE)
    with pytest.raises(RuntimeError, match="empty"):
        ours.swap()


def test_randomise_work_list_matches_reference():
    wl = make_worklist(33, 17, padded_size=600)
    ours, ref = worklist.LoadBalancer(len(wl)), jworklist.LoadBalancer(len(wl))
    ours.randomise_work_list(wl)
    ref.randomise_work_list(wl)
    np.testing.assert_array_equal(ours.work.inactive, ref.work.inactive)
    assert not np.array_equal(ours.work.inactive, wl)


@pytest.mark.parametrize("n", [1, 2, 37, 600, 601, 4097])
@pytest.mark.parametrize("tiles", [1, 5, 64, 1472])
def test_load_balancer_deal(jax_numpy_route, n, tiles):
    """The port's plain re-deal equals the JAX package's NumPy route, its
    native re-deal equals its plain one (ties kept in order: stable), and
    the deal permutes the records, never duplicates one."""
    rec = _records(n, 40, 30, 3 + n)
    lbs = {}
    for name, lb in (("native", worklist.LoadBalancer(n, tiles)),
                     ("plain", worklist.LoadBalancer(n, tiles, native=False)),
                     ("jax", jworklist.LoadBalancer(n, tiles))):
        lb.work.inactive = rec.copy()
        lb.allocate_work_by_path_length()
        lbs[name] = lb.work.inactive
    np.testing.assert_array_equal(lbs["plain"], lbs["jax"])
    np.testing.assert_array_equal(lbs["native"], lbs["plain"])
    key = lambda r: np.sort(r.view(np.uint8).reshape(n, 20).view("V20").ravel())
    np.testing.assert_array_equal(key(lbs["native"]), key(rec))


def test_load_balancer_routes_count_their_calls():
    n = 64
    native_lb, plain_lb = worklist.LoadBalancer(n, 4), worklist.LoadBalancer(n, 4, native=False)
    before = (native.load_balance.calls, native.clear_and_sum_pathlengths.calls,
              worklist.deal_order.calls, worklist.clear_and_sum_plain.calls)
    for lb in (native_lb, plain_lb):
        lb.work.inactive = _records(n, 8, 8, 9)
        lb.allocate_work_by_path_length()
        lb.clear_inactive_accumulators()
    after = (native.load_balance.calls, native.clear_and_sum_pathlengths.calls,
             worklist.deal_order.calls, worklist.clear_and_sum_plain.calls)
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1, 1]


@pytest.mark.parametrize("route", ["native", "plain"])
def test_clear_inactive_accumulators(jax_numpy_route, route):
    rec = _records(999, 30, 30, 5, max_len=0xFFFF)
    ours = worklist.LoadBalancer(len(rec), native=route == "native")
    ref = jworklist.LoadBalancer(len(rec))
    ours.work.inactive, ref.work.inactive = rec.copy(), rec.copy()
    total = ours.clear_inactive_accumulators()
    assert total == ref.clear_inactive_accumulators() == int(rec["pathLength"].sum(dtype=np.int64))
    np.testing.assert_array_equal(ours.work.inactive, ref.work.inactive)
    for f in ("r", "g", "b", "sampleCount", "pathLength"):
        assert not ours.work.inactive[f].any()
    np.testing.assert_array_equal(ours.work.inactive["u"], rec["u"])
    np.testing.assert_array_equal(ours.work.inactive["v"], rec["v"])
    ours.work.active = rec.copy()
    ours.clear_active_accumulators()
    np.testing.assert_array_equal(ours.work.active, ours.work.inactive)


# --- Film ----------------------------------------------------------------

@pytest.mark.parametrize("w,h,n", [(12, 10, 130), (64, 48, 4000)])
def test_film_native_equals_plain_and_reference(jax_numpy_route, w, h, n):
    """Native and plain films hold the same HDR bit for bit, and the JAX
    package's; the plain LDR is the JAX package's, the native one within
    1 (it rounds half up, np.rint half to even)."""
    films = {"native": film.Film(w, h), "plain": film.Film(w, h, native=False),
             "jax": jfilm.Film(w, h)}
    for step in range(3):
        rec = _records(n, w, h, 20 + step)
        for f in films.values():
            f.accumulate(rec)
    rng = np.random.default_rng(7)
    soa = dict(u=rng.integers(-2, w + 2, n), v=rng.integers(-2, h + 2, n),
               **dict(zip("rgb", rng.uniform(0, 9, (3, n)).astype(np.float32))),
               sample_count=rng.integers(0, 1 << 20, n))
    keep = np.unique(soa["v"] * (w + 8) + soa["u"], return_index=True)[1]  # unique pixels
    soa = {k: a[keep] for k, a in soa.items()}
    for f in films.values():
        f.accumulate_soa(soa["u"], soa["v"], soa["r"], soa["g"], soa["b"], soa["sample_count"])
    np.testing.assert_array_equal(films["native"].hdr, films["plain"].hdr)
    np.testing.assert_array_equal(films["plain"].hdr, films["jax"].hdr)
    for exposure, gamma in ((0.0, 2.2), (0.7, 1.8), (-1.5, 2.4)):
        plain = films["plain"].ldr(4, exposure, gamma)
        np.testing.assert_array_equal(plain, films["jax"].ldr(4, exposure, gamma))
        diff = np.abs(films["native"].ldr(4, exposure, gamma).astype(int) - plain)
        assert diff.max() <= 1


def test_film_routes_count_their_calls():
    rec = _records(50, 8, 6, 4)
    before = (native.accumulate.calls, native.accumulate_soa.calls, native.tonemap.calls,
              film.accumulate_plain.calls, film.tone_map_plain.calls)
    for f in (film.Film(8, 6), film.Film(8, 6, native=False)):
        f.accumulate(rec)
        f.accumulate_soa(rec["u"], rec["v"], rec["r"], rec["g"], rec["b"], rec["sampleCount"])
        f.ldr(1, 0.0, 2.2)
    after = (native.accumulate.calls, native.accumulate_soa.calls, native.tonemap.calls,
             film.accumulate_plain.calls, film.tone_map_plain.calls)
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1, 2, 1]


def test_native_entry_points_validate_their_operands():
    hdr = np.zeros((4, 5, 3), np.float32)
    one = np.ones(3)
    with pytest.raises(ValueError, match="lengths"):
        native.accumulate_soa(one, one, one, one, one, np.ones(2), hdr)
    with pytest.raises(ValueError, match="float32"):
        native.accumulate_soa(one, one, one, one, one, one, hdr.astype(np.float64))
    with pytest.raises(TypeError, match="TRACE_RECORD_DTYPE"):
        native.accumulate(np.zeros(3, np.float32), hdr)
    with pytest.raises(ValueError, match="writable"):
        native.clear_and_sum_pathlengths(make_worklist(4, 4)[::2])


# --- the build -----------------------------------------------------------

def test_build_reuses_the_library(tmp_path, monkeypatch):
    runs = []
    real = subprocess.run
    monkeypatch.setattr(native.subprocess, "run", lambda *a, **k: runs.append(a) or real(*a, **k))
    first = native.build(out_dir=tmp_path)
    assert first.parent == tmp_path and first.exists() and len(runs) == 1
    assert native.build(out_dir=tmp_path) == first and len(runs) == 1
    assert [p.name for p in tmp_path.iterdir()] == [first.name]  # no temporary left
    assert first.name == native.build().name  # named by source, compiler and flags


def _broken_compiler(tmp_path):
    cxx = tmp_path / "broken-g++"
    cxx.write_text("#!/bin/sh\necho 'pt_host.cpp:1: error: no compiler here' >&2\nexit 1\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    return str(cxx)


def test_build_failure_raises_with_the_compiler_output(tmp_path):
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.build(cxx=_broken_compiler(tmp_path), out_dir=tmp_path / "out")
    with pytest.raises(RuntimeError, match="cannot run"):
        native.build(cxx=str(tmp_path / "missing-g++"), out_dir=tmp_path / "out")
    assert not list((tmp_path / "out").iterdir())


def test_film_raises_rather_than_falling_back(tmp_path, monkeypatch):
    """A native Film whose library cannot be built raises; no plain
    version runs in its place."""
    monkeypatch.setattr(native, "CXX", _broken_compiler(tmp_path))
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "host")
    native._library.cache_clear()
    plain = (film.accumulate_plain.calls, film.tone_map_plain.calls)
    try:
        f = film.Film(4, 4)
        with pytest.raises(RuntimeError, match="no compiler here"):
            f.accumulate(make_worklist(4, 4))
        with pytest.raises(RuntimeError, match="no compiler here"):
            f.ldr(1, 0.0, 2.2)
        with pytest.raises(RuntimeError, match="no compiler here"):
            worklist.LoadBalancer(4).clear_inactive_accumulators()
    finally:
        native._library.cache_clear()
    assert (film.accumulate_plain.calls, film.tone_map_plain.calls) == plain
    assert os.path.isdir(tmp_path / "host")
