"""The precisions of the reference's contractions (`reference/precision.
py`), and what the v1 configuration states of them: float32 with TF32 off
gives the v1 encoder's exact outputs also on binary 0/255 content, the
widest swings that 8-bit pixels allow; its control, TF32, does not."""

import os

import numpy as np
import pytest
import torch

import portbench_toy
from benchmark import harness
from benchmark.reference import precision as prec
from benchmark.reference import transform
from benchmark.reference import wavefront_v1 as ref


def _round_significant(x, bits):
    """x rounded to `bits` significant bits, ties away from zero."""
    x = np.asarray(x, np.float64)
    e = np.floor(np.log2(np.abs(x)))
    step = 2.0 ** (e - bits + 1)
    return np.sign(x) * np.floor(np.abs(x) / step + 0.5) * step


@pytest.mark.parametrize("values", [
    [1, 90, 255, 2047, 2048, 2049, 2051, 4097, 4102, 32767, -2049, -32641],
    list(np.random.default_rng(3).integers(-2 ** 20, 2 ** 20, 64) | 1),
])
def test_tf32_rounds_operands_to_eleven_significant_bits(values):
    x = torch.tensor(values, dtype=torch.int64)
    got = prec.operands(x, "tf32").to(torch.float64).numpy()
    np.testing.assert_array_equal(got, _round_significant(values, 11))
    assert prec.operands(x, "float64").dtype == torch.float64
    np.testing.assert_array_equal(
        prec.operands(x, "bfloat16").numpy(),
        x.to(torch.bfloat16).to(torch.float32).numpy())


def test_an_unknown_precision_is_refused():
    with pytest.raises(ValueError):
        prec.matmul(torch.ones(2, 2), torch.ones(2, 2), "float16")


def _binary_frames(seed, count, height, width):
    """Frames of 16x16 blocks of 0/255: random bits, the sign patterns of
    the 16-point transform's basis products and of single basis rows or
    columns, and flat black or white, drawn block by block."""
    rng = np.random.default_rng(seed)
    t = transform.dct_matrix(16).astype(np.int64)
    out = np.zeros((count, height, width), np.uint8)
    for f in range(count):
        for y in range(0, height, 16):
            for x in range(0, width, 16):
                kind = rng.integers(0, 4)
                if kind == 0:
                    blk = rng.integers(0, 2, (16, 16)) > 0
                elif kind == 1:
                    u, v = rng.integers(1, 16, 2)
                    blk = np.outer(t[u], t[v]) > 0
                elif kind == 2:
                    blk = np.broadcast_to(t[rng.integers(1, 16)] > 0,
                                          (16, 16))
                    blk = blk.T if rng.random() < 0.5 else blk
                else:
                    blk = np.full((16, 16), rng.integers(0, 2) > 0)
                out[f, y:y + 16, x:x + 16] = np.where(blk, 255, 0)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_v1_float32_is_exact_and_tf32_is_not_on_binary_content(seed):
    config = harness.load_json(os.path.join(
        portbench_toy.ROOT, "benchmark", "configs", "regular-v1-n16.json"))
    frames = _binary_frames(seed, 2, 128, 256)

    def differ(a, b):
        return sum(int(np.count_nonzero(np.asarray(x[k])
                                        != np.asarray(y[k])))
                   for x, y in zip(a, b)
                   for k in ("recon", "modes", "levels"))

    exact = ref.encode_frames(frames, config, "cpu")
    assert differ(ref.encode_frames(frames, config, "cpu",
                                    precision="float32"), exact) == 0
    assert config["control"] == "tf32"
    assert differ(ref.encode_frames(frames, config, "cpu",
                                    precision="tf32"), exact) > 0
