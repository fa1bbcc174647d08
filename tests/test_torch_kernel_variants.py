"""The variant tool of the kernels (`ops/kernel_variants.py`, run on the
card) stays in step with the sources: every line a variant replaces is in
`csrc/fc_forward.cu`, `csrc/merger.cu`, `csrc/merger_int.cu` or
`csrc/unit_trial.cu`, and the sweep covers the tile widths and splits
that `fc_forward.plan` picks at its shapes."""

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
                              **kernel_variants.TRIAL_PROBES}}


@pytest.mark.parametrize("name,file", [
    (n, f) for f, variants in VARIANTS.items() for n in variants])
def test_variant_lines_are_in_the_source(name, file):
    variants = VARIANTS[file]
    text = source(file)
    for old, new in variants[name]:
        assert old in text and old != new


@pytest.mark.parametrize("shape", kernel_variants.FC_SHAPES)
def test_sweep_covers_the_plan(shape):
    bn, splits = fc_forward.plan(*shape, 132)
    assert bn in fc_forward.TILE_COLUMNS and splits in (1, 2, 3, 4, 6, 8)
