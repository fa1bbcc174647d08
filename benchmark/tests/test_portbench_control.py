"""The control at each cell's own size, on the card (marker `cuda`): for
three seeds, one timed call of the port on the cell's batch, and as many
of its frames as a run compares, drawn from the seed, held against the
plain reference (the lower readings: 0); then the reference itself in
the configuration's control precision (`control` in its file: it must
fail), and in the other lower precisions for the record.  Run on the
card with

    python -m pytest benchmark/tests/test_portbench_control.py -m cuda -s

which prints every reading.  The toy-size control runs on the CPU in
`test_portbench_compare.py`."""

import json
import os

import numpy as np
import pytest
import torch

import portbench_toy
from benchmark import compare, harness
from benchmark.reference import precision as prec

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)
CELLS = [w["name"] for w in harness.load_json(os.path.join(
    portbench_toy.ROOT, "BENCHMARK.json"))["workloads"]]
REF = {"wavefront2_stream": "wavefront2", "wavefront_v1": "wavefront_v1"}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _readings(checks):
    return {k: v["value"] for k, v in checks.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", CELLS)
def test_control_at_the_cells_size(card, workload, seed):
    cell, config, traffic, _ = harness.load_cell(workload,
                                                 portbench_toy.ROOT)
    path = harness.load_path(config)
    sut = path.Cell(config, traffic, seed, card, portbench_toy.ROOT)
    pick = np.random.default_rng(seed).choice(
        sut.batch, traffic["check_frames"], replace=False)
    res = sut.call(1)
    outs = [res[i] for i in pick]
    frames = sut.inputs(1)[pick]
    sut.release()
    del sut, res
    torch.cuda.empty_cache()
    ref = __import__(f"benchmark.reference.{REF[config['path']]}",
                     fromlist=["encode_frames"])
    # path.compare is the reference's encode and compare.exact_checks; the
    # reference's encode is made once here and held against each side.
    exact = ref.encode_frames(frames, config, card)
    rows = {"program": _readings(compare.exact_checks(outs, exact))}
    for precision in prec.PRECISIONS[1:]:
        ctl = ref.encode_frames(frames, config, card, precision=precision)
        rows[precision] = _readings(compare.exact_checks(ctl, exact))
    print(json.dumps({"workload": workload, "seed": seed,
                      "frames": len(frames), "control": config["control"],
                      **rows}))
    assert all(v == 0 for v in rows["program"].values())
    assert any(v > 0 for v in rows[config["control"]].values())
