"""The cases of the host codec's goldens (`tests/golden_torch/host_codec.*`).

The capture script (`scripts/capture_torch_port_golden_host.py`) encodes
these cases with the JAX package and writes their digests;
`chip_smoke.py` (phase 18) and the CPU tests encode them with the port and
compare.  Frames are the stored sources of `tests/golden_hm/`; the chroma
planes of the 4:2:0 cases come from `chroma_planes` (a seeded numpy
pattern), and the capture script stores them beside the digests.
"""

from __future__ import annotations

import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN_HM = os.path.join(REPO, "tests", "golden_hm")
GOLDEN = os.path.join(REPO, "tests", "golden_torch", "host_codec.json")
GOLDEN_NPZ = os.path.join(REPO, "tests", "golden_torch", "host_codec.npz")
MANIFEST_QUANTIZED = os.path.join(REPO, "artifacts", "frozen",
                                  "manifest_quantized.txt")
MANIFEST_TRAINED = os.path.join(REPO, "artifacts", "frozen",
                                "manifest_trained.txt")
MEAN_PKL = os.path.join(REPO, "artifacts", "training_set", "luminance",
                        "means", "mean_training.pkl")

FRAMES = {"natural128": "128_full_q32_src.npy",
          "natural96x160": "96x160_full_q37_src.npy"}
# FrameEncoder digests: (frame, policy, qp), defaults, the quantized zoo
# (singles at QP 27, pairs at QP 37) for the NN policies.
ENCODES = [(frame, policy, qp) for frame in FRAMES
           for policy in ("regular", "switch", "substitution")
           for qp in (27, 37)]
# Annex-B streams: (name, frame, policy, qp, 4:2:0).
ANNEXB = [("natural128/hm/regular", "natural128", "regular", 32, False),
          ("natural128/hm/switch", "natural128", "switch", 32, False),
          ("natural128/hm420/regular", "natural128", "regular", 32, True)]
# The RD sweep: switch against regular on the natural frame.
RD_FRAME = "natural128"
RD_QPS = (22, 27, 32, 37)
RD_POLICIES = ("regular", "switch")
# The float fallback's switch encode: (frame, qp), the float models of
# `MANIFEST_TRAINED` at `FLOAT_WIDTHS`, singles and pairs (QP 37 selects
# the pairs: FC at widths 4 / 8, conv at 16 / 32).  The float w64 models
# (73 MiB each) stay out of the card's copy, so the card's bundle stops
# at width 32; the CPU tests run the whole float zoo.
FLOAT_ENCODE = ("natural128", 37)
FLOAT_WIDTHS = (4, 8, 16, 32)


def load_frame(name: str) -> np.ndarray:
    return np.load(os.path.join(GOLDEN_HM, FRAMES[name]))


def chroma_planes(h: int, w: int, seed: int):
    """Two (h/2, w/2) uint8 chroma planes: smooth seeded gradients and
    waves with mild noise, chroma-like content for the 4:2:0 cases."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h // 2, 0:w // 2].astype(np.float64)
    planes = []
    for k in range(2):
        a, b = rng.uniform(4.0, 12.0, 2)
        p = (128 + 30 * np.sin(xx / a + k) * np.cos(yy / b)
             + 0.3 * (xx - yy) + rng.normal(0, 2.0, xx.shape))
        planes.append(np.clip(np.round(p), 0, 255).astype(np.uint8))
    return planes[0], planes[1]


def mean_training() -> float:
    import pickle

    with open(MEAN_PKL, "rb") as f:
        return float(pickle.load(f))
