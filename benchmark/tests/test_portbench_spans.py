"""The readers of the port's own spans and counters, on a toy v1 cell run
on the CPU: one call profiled by a CPU `torch.profiler` session (which
turns the port's tracing on, as the card's CUDA session does in a traced
run) gives each reader its value; without the profiled call's trace, or
in a port without a tracer, each gives None; the readback bytes a frame
are exact."""

import importlib
import sys
import time
import types

import pytest
import torch

import portbench_toy
from benchmark import harness

SPAN_METRICS = ("plan_build_s", "step_issue_ms_per_frame",
                "step_drain_ms_per_frame", "readback_ms_per_frame",
                "readback_bytes_per_frame", "native_pack_ms_per_frame",
                "pack_share_pct")
PROFILING = ("context_adaptive_neural_network_based_prediction_tpu_torch."
             "utils.profiling")


def readback_bytes(h, w, n):
    """Reconstruction (uint8), modes and levels (int32) of one frame."""
    nby, nbx = h // n, w // n
    return h * w + nby * nbx * 4 + nby * nbx * n * n * 4


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    prof = importlib.import_module(PROFILING)
    root = portbench_toy.make_root(tmp_path_factory.mktemp("spans"),
                                   "regular-v1-n16")
    cell, config, traffic, bench = harness.load_cell("toy", root)
    path = harness.load_path(config)
    prof.disable()
    prof.reset()
    sut = path.Cell(config, traffic, 2147483901, torch.device("cpu"), root)
    sut.release()                       # the plan is built in the warm-up
    sut.warm_up()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        sut.call(1)
        wall = time.perf_counter() - t0
    rec = {"cell": cell, "config": config, "traffic": traffic, "spans": {},
           "counters": {"frames": sut.batch}, "least_s": {},
           "trace": {"window_s": wall, "busy_s": 0.0, "kernel_s": {}}}
    readers = harness.metric_readers(bench, "toy")
    yield rec, readers, sut, prof
    sut.release()
    prof.reset()


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_each_reader_reads_the_profiled_call(traced, name):
    rec, readers, _, _ = traced
    read, _ = readers[name]
    v = read(rec)
    assert v is not None and v > 0, name
    if name.endswith("_pct"):
        assert v <= 100.0


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_each_reader_gives_nothing_without_the_trace(traced, name):
    rec, readers, _, _ = traced
    read, _ = readers[name]
    assert read(dict(rec, trace=None)) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_each_reader_gives_nothing_from_a_port_without_a_tracer(
        traced, name, monkeypatch):
    rec, readers, _, prof = traced
    monkeypatch.setitem(sys.modules, prof.__name__,
                        types.ModuleType("tracer_less"))
    read, _ = readers[name]
    assert read(rec) is None


def test_readback_bytes_per_frame_is_exact(traced):
    rec, readers, sut, _ = traced
    read, _ = readers["readback_bytes_per_frame"]
    assert read(rec) == readback_bytes(sut.h, sut.w, sut.n)
    # The cell's frames: 1056x1920 at n = 16.
    assert readback_bytes(1056, 1920, 16) == 10_169_280


def test_pack_share_is_the_packs_share_of_the_window(traced):
    rec, readers, sut, prof = traced
    grids = [s for s in prof.spans() if s[0] == "pack.grid"]
    assert len(grids) == sut.batch
    total = sum(s[2] - s[1] for s in grids) * 1e-9
    assert readers["pack_share_pct"][0](rec) == pytest.approx(
        100.0 * total / rec["trace"]["window_s"])
