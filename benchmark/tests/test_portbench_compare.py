"""The comparison that decides `correct`, on the outputs of each cell's
path taken from the port's CPU path at a toy frame size: equal to the
plain reference; a flipped reconstruction pixel, a flipped stream byte,
a changed mode or level fail it.  And a whole run, with the timed path
broken underneath, reports `correct` false; without a card the
measurement path refuses to run."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import portbench_toy
from benchmark import harness

ROOT = portbench_toy.ROOT
CELLS = {"switch-ctb32": "wavefront2_stream", "regular-v1-n16": "wavefront_v1"}


@pytest.fixture(scope="module", params=sorted(CELLS))
def port_outputs(request, tmp_path_factory):
    """(config, traffic, [(frame, the port's outputs)], path module)."""
    root = portbench_toy.make_root(tmp_path_factory.mktemp("c"),
                                   request.param)
    cell, config, traffic, _ = harness.load_cell("toy", root)
    path = harness.load_path(config)
    import torch
    sut = path.Cell(config, traffic, 11, torch.device("cpu"), root)
    outs = sut.call(1)
    pairs = list(zip(sut.inputs(1), outs))
    return config, traffic, pairs, path


def test_the_port_equals_the_reference(port_outputs):
    config, traffic, pairs, path = port_outputs
    checks = path.compare(config, traffic, pairs, "cpu")
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in checks.values()), checks
    assert "streams_differ" in checks and "recon_px_differ" in checks


def _flipped(pairs, key):
    bad = copy.deepcopy(pairs)
    out = bad[-1][1]
    if key == "recon":
        out["recon"] = out["recon"].copy()
        out["recon"][3, 5] ^= 1
    elif key == "stream":
        s = bytearray(out["stream"])
        s[len(s) // 2] ^= 0x10
        out["stream"] = bytes(s)
    else:
        out[key] = out[key].copy()
        out[key].reshape(-1)[0] += 1
    return bad


def test_each_flipped_output_fails(port_outputs):
    config, traffic, pairs, path = port_outputs
    keys = [k for k in ("recon", "stream", "modes", "levels")
            if k in pairs[0][1]]
    for key in keys:
        checks = path.compare(config, traffic, _flipped(pairs, key), "cpu")
        name = {"recon": "recon_px_differ",
                "stream": "streams_differ"}.get(key, f"{key}_differ")
        assert checks[name]["value"] >= 1 > checks[name]["limit"], key
        assert not all(c["value"] <= c["limit"] for c in checks.values())


def test_the_control_fails(port_outputs):
    """The reference in the configuration's control precision (a lower
    one than its exact contractions') put in the program's place is not
    correct."""
    config, traffic, pairs, path = port_outputs
    ref = __import__(f"benchmark.reference.{_ref_module(config)}",
                     fromlist=["encode_frames"])
    frames_ = np.stack([f for f, _ in pairs])
    control = ref.encode_frames(frames_, config, "cpu",
                                precision=config["control"])
    checks = path.compare(config, traffic, list(zip(frames_, control)),
                          "cpu")
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def _ref_module(config):
    return {"wavefront2_stream": "wavefront2",
            "wavefront_v1": "wavefront_v1"}[config["path"]]


FAULTS = {
    # An answer altered where it is produced: one reconstruction pixel.
    "recon": lambda outs: [dict(o, recon=np.where(
        np.arange(o["recon"].size).reshape(o["recon"].shape) == 7,
        o["recon"] ^ 4, o["recon"]).astype(np.uint8)) for o in outs],
    # An answer altered where it is produced: one stream byte.
    "stream": lambda outs: [dict(o, stream=o["stream"][:-1] + bytes(
        [o["stream"][-1] ^ 0x01])) for o in outs],
    # Half of the batch left out: its frames come back as the other
    # half's.
    "half_batch": lambda outs: outs[:len(outs) // 2] * 2,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("config", sorted(CELLS))
def test_a_run_over_a_broken_path_is_not_correct(tmp_path, monkeypatch,
                                                 config, fault):
    root = portbench_toy.make_root(tmp_path, config, batch=2,
                                   check_frames=2)
    path = harness.load_path(harness.load_cell("toy", root)[1])
    honest = path.Cell.call
    monkeypatch.setattr(path.Cell, "call",
                        lambda self, k: FAULTS[fault](honest(self, k)))
    r = harness.run("toy", 5, 0.01, False, t_start=0.0, device="cpu",
                    require_card=False, root=root, log=lambda m: None)
    assert r["correct"] is False, r["checks"]
    assert list(r)[-1] == "checks"


def test_without_a_card_the_benchmark_refuses_to_run():
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         bench["workloads"][0]["name"],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in out.stderr


def test_the_result_line_ends_with_the_checks(tmp_path):
    root = portbench_toy.make_root(tmp_path, "regular-v1-n16")
    r = harness.run("toy", 9, 0.01, False, t_start=0.0, device="cpu",
                    require_card=False, root=root, log=lambda m: None)
    line = json.dumps(r)
    assert set(r) == {"correct", "attempted", "failed", "metrics", "device",
                      "checks"}
    assert list(json.loads(line))[-1] == "checks"
    assert r["correct"] is True and r["attempted"] >= 2
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
