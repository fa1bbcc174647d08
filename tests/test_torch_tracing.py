"""The port's spans and counters (`utils/profiling.py`) and where the
encode paths take them.

CPU: with tracing off and no profiler a span records nothing and enters
no `record_function`; `enable()` records nested spans with their parents
and batch ids, and self time is duration less children; under a
`torch.profiler` session every span is a `record_function` event of its
name, on the tracer's clock; a toy v1 batch encode and its packs give the
v1 span tree and the readback bytes of its shapes; a toy switch stream
gives the `w2.*` spans.
The card case (marker `cuda`) checks that a profiler session recording
CUDA activity only also turns tracing on.  The file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

import gc
import inspect
import os
import time
import tracemalloc

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    native)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    wavefront, wavefront2)
from context_adaptive_neural_network_based_prediction_tpu_torch.utils import (
    profiling)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE = os.path.join(REPO, "tests", "golden_torch",
                      "w2_nn_random_bundle.npz")


@pytest.fixture(autouse=True)
def clean_tracer():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_inactive_span_records_nothing_and_enters_no_record_function(
        monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a))
    assert not profiling.active()
    first = profiling.span("a")
    for i in range(100):
        with profiling.span("b", batch=True) as s:
            profiling.count("c", 3)
        assert s is first
    assert profiling.spans() == [] and profiling.counters() == {}
    assert entered == [] and profiling.self_times() == {}


def peak_bytes(span, count):
    """Peak bytes traced over 1000 calls of `span` and `count`, the loop's
    own included."""
    def calls():
        for _ in range(1000):
            span("b")
            count("c")

    calls()
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        calls()
        return tracemalloc.get_traced_memory()[1] - base
    finally:
        tracemalloc.stop()


def test_an_inactive_span_allocates_nothing():
    """No more than the same loop over functions that do nothing (an
    object made per span shows as more)."""
    def nothing(name):
        return None

    assert peak_bytes(profiling.span, profiling.count) <= peak_bytes(
        nothing, nothing)


def test_the_tracer_reads_no_environment_variable():
    assert "environ" not in inspect.getsource(profiling)


def test_enable_records_nested_spans_with_parents_and_batches():
    profiling.enable()
    for _ in range(2):
        with profiling.span("x.encode_batch", {"frames": 2}, batch=True):
            with profiling.span("x.steps", batch=True):
                with profiling.span("x.pnn", {"n": 4}):
                    pass
            with profiling.span("x.readback"):
                pass
        with profiling.span("x.pack"):
            pass
    got = [(name, parent, batch, attrs)
           for name, _, _, parent, batch, attrs in profiling.spans()]
    assert got == [
        ("x.encode_batch", None, 1, {"frames": 2}), ("x.steps", 0, 1, {}),
        ("x.pnn", 1, 1, {"n": 4}), ("x.readback", 0, 1, {}),
        ("x.pack", None, 1, {}),
        ("x.encode_batch", None, 2, {"frames": 2}), ("x.steps", 5, 2, {}),
        ("x.pnn", 6, 2, {"n": 4}), ("x.readback", 5, 2, {}),
        ("x.pack", None, 2, {})]
    for _, s0, s1, parent, _, _ in profiling.spans():
        assert s0 <= s1
        if parent is not None:
            p = profiling.spans()[parent]
            assert p[1] <= s0 and s1 <= p[2]


def test_self_time_is_duration_less_children():
    profiling.enable()
    with profiling.span("outer"):
        time.sleep(0.002)
        for _ in range(2):
            with profiling.span("inner"):
                time.sleep(0.003)
    sp = profiling.spans()
    dur = lambda s: (s[2] - s[1]) * 1e-9
    selfs = profiling.self_times()
    assert selfs["outer"] == pytest.approx(
        dur(sp[0]) - dur(sp[1]) - dur(sp[2]), abs=1e-12)
    assert selfs["inner"] == pytest.approx(dur(sp[1]) + dur(sp[2]),
                                           abs=1e-12)
    assert selfs["outer"] >= 0.002 and selfs["inner"] >= 0.006


def test_a_decorated_function_is_traced_at_each_call():
    @profiling.traced("deco", {"k": 1}, batch=True)
    def f(x):
        return x + 1

    assert f(1) == 2 and profiling.spans() == []
    profiling.enable()
    assert f(2) == 3 and f(3) == 4
    assert [(s[0], s[4], s[5]) for s in profiling.spans()] == [
        ("deco", 1, {"k": 1}), ("deco", 2, {"k": 1})]
    assert f.__name__ == "f"


def test_only_a_batch_span_opens_a_batch():
    profiling.enable()
    with profiling.span("pack"):
        pass
    with profiling.span("call", batch=True):
        pass
    for _ in range(2):
        with profiling.span("pack"):
            pass
    assert [s[4] for s in profiling.spans()] == [0, 1, 1, 1]


def test_a_setup_span_records_while_tracing_is_off():
    with profiling.setup_span("plan_build"):
        with profiling.span("inside"):
            pass
    assert [s[0] for s in profiling.spans()] == ["plan_build"]


def test_report_is_the_stage_timer_format():
    profiling.enable()
    for _ in range(3):
        with profiling.span("encode"):
            pass
    lines = profiling.report().splitlines()
    assert lines[0] == profiling.StageTimer().report()
    assert lines[1].split()[0] == "encode" and lines[1].split()[2] == "3"


def test_a_span_open_across_a_reset_is_not_recorded():
    profiling.enable()
    with profiling.span("old"):
        profiling.reset()
        with profiling.span("new"):
            pass
    assert [(s[0], s[3]) for s in profiling.spans()] == [("new", None)]


def clock_deltas(names):
    """(start, end) of each span less its `record_function` event's, ns,
    from one CPU profiler session (with a first span that warms the
    session's own set-up)."""
    profiling.reset()
    gc.disable()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            assert profiling.active()
            for name in ["warm"] + names:
                with profiling.span(name):
                    torch.ones(64).sum()
    finally:
        gc.enable()
    assert not profiling.active()
    ours = {s[0]: s[1:3] for s in profiling.spans()}
    theirs = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in ours}
    assert set(ours) == set(theirs) == {"warm", *names}
    return [(ours[n][0] - theirs[n][0], ours[n][1] - theirs[n][1])
            for n in names]


def test_a_profiler_session_turns_tracing_on_and_shares_its_clock():
    """Each span's stamps lie within 100 µs of its profiler event's.  The
    gap is the `record_function` call's own cost; a session in which the
    host was taken away from the test (a preempted worker) is made
    again, up to three times."""
    names = [f"clock.{i}" for i in range(8)]
    for _ in range(3):
        deltas = clock_deltas(names)
        if all(abs(d) < 100_000 for pair in deltas for d in pair):
            break
    assert all(abs(d) < 100_000 for pair in deltas for d in pair), deltas


def test_counters_list_the_kernel_launches_once():
    """The kernels count their launches in their own dicts; the tracer
    neither repeats nor zeroes them."""
    from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
        unit_fused)

    before = unit_fused.launches[8]
    unit_fused.launches[8] += 5
    try:
        profiling.enable()
        profiling.count("v1.readback_bytes", 5)
        assert profiling.counters() == {"v1.readback_bytes": 5}
        profiling.reset()
        assert profiling.counters() == {}
        assert unit_fused.launches[8] == before + 5
    finally:
        unit_fused.launches[8] = before


def v1_frames(nf, h, w):
    return np.random.default_rng(3).integers(0, 256, (nf, h, w),
                                             dtype=np.uint8)


@pytest.mark.parametrize("n", [8, 16])
def test_v1_batch_and_packs_give_the_span_tree(n):
    nf, h, w = 2, 32, 64
    frames = v1_frames(nf, h, w)
    want = wavefront.encode_frames_wavefront_batch(frames, 32, block_size=n,
                                                   device="cpu")
    wavefront._PLAN_CACHE.clear()
    profiling.reset()
    profiling.enable()
    got = wavefront.encode_frames_wavefront_batch(frames, 32, block_size=n,
                                                  device="cpu")
    streams = [native.serialize_grid(got[1][f], got[2][f], width=w,
                                     height=h, n=n, qp=32)
               for f in range(nf)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    sp = profiling.spans()
    tree = [(s[0], None if s[3] is None else sp[s[3]][0]) for s in sp]
    assert tree == [
        ("v1.encode_batch", None), ("v1.plan", "v1.encode_batch"),
        ("v1.plan_build", "v1.plan"), ("v1.upload", "v1.encode_batch"),
        ("v1.steps", "v1.encode_batch"), ("v1.drain", "v1.encode_batch"),
        ("v1.readback", "v1.encode_batch")] + [
        ("pack.grid", None), ("pack.header", "pack.grid"),
        ("pack.native", "pack.grid")] * nf
    assert {s[4] for s in sp} == {1}
    nby, nbx = h // n, w // n
    assert profiling.counters() == {
        "v1.readback_bytes": nf * (h * w + nby * nbx * 4
                                   + nby * nbx * n * n * 4)}
    assert all(streams)


@pytest.fixture(scope="module")
def bundle():
    return zoo.load_bundle_npz(BUNDLE)


def test_switch_stream_gives_the_w2_spans(bundle):
    frames = [v1_frames(1, 32, 64)[0] for _ in range(2)]
    wavefront2._PLAN_CACHE.clear()
    profiling.enable()
    res = list(wavefront2.encode_stream_wavefront2(
        iter(frames), 37, batch=2, policy="switch", pnn=bundle,
        rate_evolve=True, device="cpu"))
    assert len(res) == 2
    sp = profiling.spans()
    tree = [(s[0], None if s[3] is None else sp[s[3]][0]) for s in sp]
    assert tree == [
        ("w2.encode_batch", None), ("w2.plan_build", "w2.encode_batch"),
        ("w2.steps", "w2.encode_batch"), ("w2.readback", "w2.encode_batch"),
        ("w2.pack", "w2.encode_batch")]
    assert {s[4] for s in sp} == {1}


def test_a_batch_call_is_one_w2_batch():
    frames = v1_frames(2, 64, 64)
    profiling.enable()
    for _ in range(2):
        wavefront2.encode_arrays_wavefront2_batch(frames, 32, ctb=64,
                                                  device="cpu")
    got = [(s[0], s[4]) for s in profiling.spans()
           if s[0] != "w2.plan_build"]
    assert got == [("w2.encode_batch", 1), ("w2.steps", 1),
                   ("w2.readback", 1), ("w2.encode_batch", 2),
                   ("w2.steps", 2), ("w2.readback", 2)]


@pytest.mark.cuda
def test_a_cuda_only_profiler_session_turns_tracing_on():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    x = torch.ones(1 << 20, device=dev)
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        assert profiling.active()
        with profiling.span("card"):
            (x * 2).sum().item()
    assert not profiling.active()
    assert [s[0] for s in profiling.spans()] == ["card"]
