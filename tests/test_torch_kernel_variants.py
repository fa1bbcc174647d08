"""The variant tool of the kernels (`ops/kernel_variants.py`, run on the
card) stays in step with the sources: every line a variant replaces is in
`csrc/fc_forward.cu`, `csrc/merger.cu`, `csrc/merger_int.cu` or
`csrc/unit_trial.cu`, the n = 16 / 32 trial's shape constants are read
from its source, and the sweep covers the tile widths and splits that
`fc_forward.plan` picks at its shapes."""

import os

import pytest

from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    _cuda_build, fc_forward, kernel_variants)


def source(name):
    with open(os.path.join(_cuda_build.CSRC, name)) as f:
        return f.read()


VARIANTS = {"fc_forward.cu": kernel_variants.FC_PROBES,
            "merger.cu": kernel_variants.MERGER_VARIANTS,
            "merger_int.cu": kernel_variants.MERGER_INT_VARIANTS,
            "unit_trial.cu": {**kernel_variants.TRIAL_VARIANTS,
                              **kernel_variants.TRIAL_PROBES,
                              **kernel_variants.TRIAL_LARGE_VARIANTS}}


@pytest.mark.parametrize("name,file", [
    (n, f) for f, variants in VARIANTS.items() for n in variants])
def test_variant_lines_are_in_the_source(name, file):
    variants = VARIANTS[file]
    text = source(file)
    for old, new in variants[name]:
        assert text.count(old) == 1 and old != new


def test_large_knobs_come_from_the_source():
    """The n = 16 / 32 kernel's eight shape constants are read from the
    source, each set on one line, so a variant replaces exactly one."""
    knobs = kernel_variants.large_knobs()
    assert sorted(knobs) == sorted(
        f"{k}_{n}" for k in ("CLUSTER", "WARPS", "MAX_THREADS", "MIN_BLOCKS")
        for n in (16, 32))
    text = source("unit_trial.cu")
    for k, v in knobs.items():
        assert text.count(f"constexpr int {k} = ") == 1 and v > 0, k
        assert 36 % knobs[f"CLUSTER_{k[-2:]}"] == 0


@pytest.mark.parametrize("shape", kernel_variants.FC_SHAPES)
def test_sweep_covers_the_plan(shape):
    bn, splits = fc_forward.plan(*shape, 132)
    assert bn in fc_forward.TILE_COLUMNS and splits in (1, 2, 3, 4, 6, 8)
