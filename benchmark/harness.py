"""The benchmark harness: one run of one cell, found by name.

`BENCHMARK.json` names the cell; the cell names a configuration
(`configs/<name>.json`) and a traffic mix (`traffic/<name>.json`); the
configuration names the encode path (`paths/<name>.py`, which drives the
port and its plain reference); each per-layer metric is a reader of its
own (`metrics/<name>.py`).  Nothing here knows a cell, a configuration or
a metric by name, so a later cell or metric is new files only.

A run: set-up (the port's libraries, the plan, the models, the frames of
the seed, one warm-up call at the cell's shapes), then either the
measured window (`--trace 0`: closed-loop calls until `--seconds` are
spent; the end-to-end metrics) or the traced calls (`--trace 1`: one
profiled call, one call split into its device half and its host pack,
one call under an aten-op counter, the path's own layer timings; the
per-layer metrics), then the comparison of a seeded sample of the
outputs with the plain reference, and one JSON line on stdout.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level module names that no process of the benchmark may load: the
# JAX stack and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax",
             "context_adaptive_neural_network_based_prediction_tpu")
N_BREAKDOWN = 10


class NoCard(RuntimeError):
    """The run needs NVIDIA cards that this machine does not have."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: str = ROOT):
    """(cell, configuration, traffic, the benchmark's JSON) of a workload,
    each found by its name."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(root, "benchmark", "traffic",
                                     f"{cell['traffic']}.json"))
    return cell, config, traffic, bench


def load_path(config):
    """The module of the configuration's encode path."""
    return importlib.import_module(f"benchmark.paths.{config['path']}")


def metric_readers(bench, workload: str):
    """{metric name: (read function, unit)} of the per-layer metrics
    reported in this cell."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        mod = importlib.import_module(
            f"benchmark.metrics.{m['name'].replace('.', '_')}")
        out[m["name"]] = (mod.read, m["unit"])
    return out


def forbidden_loaded(modules=None):
    """Loaded modules whose whole top-level name is forbidden."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".")[0] in FORBIDDEN)


def require_cards(count: int):
    """Raises NoCard unless this machine has `count` CUDA cards."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark "
                     "measures the port on NVIDIA cards")
    if torch.cuda.device_count() < count:
        raise NoCard(f"the cell needs {count} cards, the machine has "
                     f"{torch.cuda.device_count()}")


def card_rates(device):
    """(int32, FP64 tensor-core) operations per second of the card, from
    its SM count and its maximum SM clock; None off a card."""
    from benchmark import roofline

    if device.type != "cuda":
        return None
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
        capture_output=True, text=True, timeout=60).stdout.split()[0]
    return roofline.card_rates(sms, float(mhz))


def count_dispatched_ops(fn):
    """(fn's result, the aten ops it dispatched, views included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    count = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            count[0] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, count[0]


def _merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _gap_names(gaps, cpu_ev):
    """{host call name: idle seconds}: each idle gap of the device named
    by the innermost host call running at its middle.  `gaps` and
    `cpu_ev` ((start, end, name), ns) sorted by start; the calls of one
    thread nest, so one sweep with a stack finds the innermost."""
    out, stack, i = {}, [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(cpu_ev) and cpu_ev[i][0] <= mid:
            while stack and stack[-1][1] <= cpu_ev[i][0]:
                stack.pop()
            stack.append(cpu_ev[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "host code between CUDA calls"
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-9
    return out


def profile_call(fn, device):
    """One call of `fn` under the profiler's CUDA activity: (fn's result,
    the trace's summary).  The summary has the call's wall seconds, the
    seconds in which a device activity (kernel, copy, set) ran, seconds
    by device activity name, and the idle gaps' seconds by the CUDA
    runtime call that the host was in (else host code between them);
    None where the profiler recorded no device activity.  Host ops are
    not recorded: a switch call dispatches some 650,000 aten ops, whose
    ten million nested events took the profiler minutes to stop and
    read.  The raw events are read as they come (`kineto_results`),
    without the profiler's own per-event tree."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    t_stop = time.perf_counter() - t0 - wall
    cuda = torch.autograd.DeviceType.CUDA
    dev_ev, cpu_ev = [], []
    for e in prof.profiler.kineto_results.events():
        s0 = e.start_ns()
        rec = (s0, s0 + e.duration_ns(), e.name())
        (dev_ev if e.device_type() == cuda else cpu_ev).append(rec)
    if not dev_ev:
        return out, None
    by_name = {}
    for s0, s1, name in dev_ev:
        by_name[name] = by_name.get(name, 0.0) + (s1 - s0) * 1e-9
    busy = _merge([(s0, s1) for s0, s1, _ in dev_ev])
    busy_s = sum(s1 - s0 for s0, s1 in busy) * 1e-9
    cpu_ev.sort()
    lo = min(cpu_ev[0][0], busy[0][0]) if cpu_ev else busy[0][0]
    hi = max(max(e for _, e, _ in cpu_ev) if cpu_ev else 0, busy[-1][1])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0]
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])]
    return out, dict(window_s=wall, busy_s=busy_s, kernel_s=by_name,
                     stop_s=t_stop, n_events=len(dev_ev) + len(cpu_ev),
                     device_ops=top(by_name)[:N_BREAKDOWN],
                     idle_gaps=top(_gap_names(gaps, cpu_ev))[:N_BREAKDOWN])


class Kept:
    """The outputs of the calls kept for the comparison: `per_call` frames
    of each call, drawn from the seed."""

    def __init__(self, seed, batch, per_call):
        self.rng = np.random.default_rng(seed)
        self.batch, self.per_call = batch, min(per_call, batch)
        self.items = []          # (call, frame index, outputs)

    def add(self, k, outputs):
        for i in sorted(self.rng.choice(self.batch, self.per_call,
                                        replace=False)):
            self.items.append((k, int(i), outputs[i]))

    def sample(self, count):
        pick = self.rng.choice(len(self.items), min(count, len(self.items)),
                               replace=False)
        return [self.items[j] for j in sorted(pick)]


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device=None, require_card: bool = True,
        root: str = ROOT, log=print):
    """One run; returns the result dict (its `checks` key last).  Raises
    NoCard when the machine lacks the cell's cards."""
    cell, config, traffic, bench = load_cell(workload, root)
    if require_card:
        require_cards(cell["chips"])
    device = torch.device(device or "cuda:0")
    path = load_path(config)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    sut = path.Cell(config, traffic, seed, device, root)
    sut.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s ({workload}, seed {seed})")
    kept = Kept(seed, sut.batch, traffic["check_frames"])
    metrics, breakdown, dev_extra = {}, None, {}
    attempted = 0
    if not trace:
        t0 = time.perf_counter()
        k = 0
        while True:
            k += 1
            outs = sut.call(k)
            attempted += len(outs)
            kept.add(k, outs)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        log(f"window {window_s:.3f} s: {k} calls, {attempted} frames")
        metrics["frames_per_s"] = {"value": attempted / window_s,
                                   "unit": "frames/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        rec = {"cell": cell, "config": config, "traffic": traffic,
               "spans": {}, "counters": {}, "least_s": {}, "trace": None}
        lap = time.perf_counter()

        def phase(name):
            nonlocal lap
            now = time.perf_counter()
            log(f"{name}: {now - lap:.3f} s")
            lap = now

        if device.type == "cuda":
            outs, rec["trace"] = profile_call(lambda: sut.call(1), device)
        else:
            outs = sut.call(1)
        phase("profiled call and its trace")
        attempted += len(outs)
        kept.add(1, outs)
        rec["spans"].update(sut.split_call(2))
        phase("split call")
        outs, n_ops = count_dispatched_ops(lambda: sut.call(3))
        phase("counted call")
        attempted += len(outs)
        kept.add(3, outs)
        rec["counters"].update(aten_ops=n_ops, steps=sut.steps,
                               frames=sut.batch)
        rec["spans"].update(sut.layer_spans())
        phase("layer spans")
        rates = card_rates(device)
        if rates is not None:
            rec["least_s"].update(sut.least_s(rates))
        for name, (read, unit) in metric_readers(bench, workload).items():
            v = read(rec)
            if v is not None:
                metrics[name] = {"value": v, "unit": unit}
        if rec["trace"] is not None:
            dev_extra = {"busy_s": rec["trace"]["busy_s"],
                         "window_s": rec["trace"]["window_s"]}
            breakdown = {"device_ops": rec["trace"]["device_ops"],
                         "idle_gaps": rec["trace"]["idle_gaps"]}
            log(f"trace: window {rec['trace']['window_s']:.3f} s, stop "
                f"{rec['trace']['stop_s']:.3f} s, "
                f"{rec['trace']['n_events']} events")
        log("per-layer: " + json.dumps(metrics))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = max(torch.cuda.max_memory_allocated(d)
                   for d in range(cell["chips"]))
        kind = torch.cuda.get_device_name(device)
    else:
        peak, kind = 0, "cpu"
    sample = kept.sample(traffic["check_frames"])
    inputs = {k: sut.inputs(k) for k in {k for k, _, _ in sample}}
    sut.release()
    del sut
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = path.compare(config, traffic, [
        (inputs[k][i], out) for k, i, out in sample], device)
    log(f"comparison with the plain reference on {len(sample)} frames: "
        f"{time.perf_counter() - t_ref:.3f} s")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type, "kind": kind, "count":
                         cell["chips"], "memory_peak_bytes": int(peak),
                         **dev_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
