"""The variant tool of the float kernels (`ops/kernel_variants.py`, run on
the card) stays in step with the sources: every line a variant replaces
is in `csrc/fc_forward.cu` or `csrc/merger.cu`, and the sweep covers the
tile widths and splits that `fc_forward.plan` picks at its shapes."""

import os

import pytest

from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    _cuda_build, fc_forward, kernel_variants)


def source(name):
    with open(os.path.join(_cuda_build.CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("name,file", [
    *((n, "fc_forward.cu") for n in kernel_variants.FC_PROBES),
    *((n, "merger.cu") for n in kernel_variants.MERGER_VARIANTS)])
def test_variant_lines_are_in_the_source(name, file):
    variants = (kernel_variants.FC_PROBES if file == "fc_forward.cu"
                else kernel_variants.MERGER_VARIANTS)
    text = source(file)
    for old, new in variants[name]:
        assert old in text and old != new


@pytest.mark.parametrize("shape", kernel_variants.FC_SHAPES)
def test_sweep_covers_the_plan(shape):
    bn, splits = fc_forward.plan(*shape, 132)
    assert bn in fc_forward.TILE_COLUMNS and splits in (1, 2, 3, 4, 6, 8)
