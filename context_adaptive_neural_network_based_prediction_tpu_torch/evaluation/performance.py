"""Rate-distortion evaluation: per-QP encode/decode, curves, BD-rate.

The port's copy of the JAX package's `evaluation/performance.py` (the
reference's `hevc/performance.py` + `comparing_rate_distortion.py`):
encode one luma frame at each QP with the host RDO encoder, decode it back
and measure (rate bpp, PSNR, encode and decode time), cache the sweep, and
compute Bjontegaard deltas over the low / high / full QP ranges (split at
the list midpoint, `comparing_rate_distortion.py:385-390`).  The NN
policies' PNN forwards run on `device` ("cuda" by default; a CUDA device
without a card raises).  `plot_rate_distortion_curves` draws the curves
(matplotlib, imported when it is called).
"""

from __future__ import annotations

import os
import pickle
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..codec import decoder, encoder, hm_decoder, hm_encoder, nn_intra
from ..parallel import wavefront
from ..utils import metrics

# Reference QP protocol (comparing_rate_distortion.py:536-537).
QPS_RD = (17, 19, 22, 24, 27, 32, 34, 37, 39, 42)


@dataclass
class RdPoint:
    qp: int
    rate_bpp: float
    psnr_db: float
    encode_time_s: float
    decode_time_s: float


def compute_rate_psnr(luminance_uint8: np.ndarray, qp: int, *,
                      policy: str = "regular", pnn=None,
                      use_wavefront: bool = False,
                      use_hm_container: bool = False, device="cuda",
                      **encoder_kwargs) -> RdPoint:
    """Encodes + decodes one luma frame; asserts bit-exact reconstruction.

    `pnn` is a `PnnPredictor` or a `PnnBundle`; its forwards run on
    `device`.  `use_hm_container` serializes the decisions as a standard
    Annex-B HEVC stream (VPS/SPS/PPS + IDR slice + hash SEI,
    `codec.hm_encoder`) and uses ITS length as the rate; the
    reconstruction is then checked through the HM-syntax decoder
    (`codec.hm_decoder`, native slice parser, every policy) and its
    decoded-picture hash.  Otherwise the framework stream is decoded by
    `codec.decoder`."""
    dev = nn_intra.check_device(device)
    if pnn is not None:
        pnn = nn_intra.as_predictor(pnn, dev)
    h, w = luminance_uint8.shape
    t0 = time.time()
    if use_wavefront:
        res = wavefront.encode_frame_wavefront(luminance_uint8, qp,
                                               device=dev, **encoder_kwargs)
    else:
        fe = encoder.FrameEncoder(luminance_uint8, qp, policy=policy, pnn=pnn,
                                  device=dev, **encoder_kwargs)
        res = fe.encode()
    t1 = time.time()
    if use_hm_container:
        if use_wavefront:
            raise ValueError("HM container rate needs the RDO encoder path")
        stream = hm_encoder.assemble_hm_stream(
            res, sao_enabled=fe.sao, deblocking=fe.deblocking,
            sign_hiding=fe.sign_hiding, transform_skip=fe.transform_skip,
            max_tu_depth=fe.max_tu_depth, sao_grid=fe._sao_grid,
            strong_intra_smoothing=fe.strong_smoothing, ctu_size=fe.ctu)
        num_bits = len(stream) * 8
        hd = hm_decoder.decode_hm_stream(stream, policy=policy, pnn=pnn,
                                         device=dev)
        recon = hd.reconstruction
        if hd.hash_checked and not hd.hash_ok:
            raise AssertionError("decoded-picture-hash mismatch")
    else:
        num_bits = res.num_bits
        recon = decoder.decode_frame(res.bitstream, pnn=pnn,
                                     device=dev).reconstruction
    t2 = time.time()
    if not np.array_equal(res.reconstruction, recon):
        raise AssertionError("decoder reconstruction mismatch")
    return RdPoint(qp=qp,
                   rate_bpp=num_bits / (h * w),
                   psnr_db=float(metrics.compute_psnr(luminance_uint8, recon)),
                   encode_time_s=t1 - t0,
                   decode_time_s=t2 - t1)


def compute_or_load_rates_psnrs(luminance_uint8: np.ndarray,
                                qps: Sequence[int],
                                path_to_cache: Optional[str] = None,
                                **kwargs) -> List[RdPoint]:
    """Pickle-cached RD sweep (reference compute_or_load_rates_psnrs:137)."""
    if path_to_cache and os.path.isfile(path_to_cache):
        with open(path_to_cache, "rb") as f:
            return pickle.load(f)
    points = [compute_rate_psnr(luminance_uint8, qp, **kwargs) for qp in qps]
    if path_to_cache:
        os.makedirs(os.path.dirname(path_to_cache) or ".", exist_ok=True)
        with open(path_to_cache, "wb") as f:
            pickle.dump(points, f)
    return points


def bd_rate_low_high_full(points_anchor: List[RdPoint],
                          points_test: List[RdPoint]) -> dict:
    """BD-rate (%) of test vs anchor over low/high/full QP ranges."""
    def split(points):
        mid = len(points) // 2
        return points[:mid], points[mid:]

    def bd(a, t):
        return metrics.compute_bjontegaard(
            np.array([p.rate_bpp for p in a]), np.array([p.psnr_db for p in a]),
            np.array([p.rate_bpp for p in t]), np.array([p.psnr_db for p in t]))

    a_low, a_high = split(points_anchor)
    t_low, t_high = split(points_test)
    return {
        "low": bd(a_low, t_low),
        "high": bd(a_high, t_high),
        "full": bd(points_anchor, points_test),
    }


def plot_rate_distortion_curves(list_of_points: dict, path_to_png: str,
                                title: str = "") -> None:
    """Saves an RD-curve comparison plot ({label: [RdPoint, ...]})."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for label, points in list_of_points.items():
        ax.plot([p.rate_bpp for p in points], [p.psnr_db for p in points],
                marker="o", label=label)
    ax.set_xlabel("rate (bpp)")
    ax.set_ylabel("PSNR (dB)")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    os.makedirs(os.path.dirname(path_to_png) or ".", exist_ok=True)
    fig.savefig(path_to_png, dpi=120, bbox_inches="tight")
    plt.close(fig)
