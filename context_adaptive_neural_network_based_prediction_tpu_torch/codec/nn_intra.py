"""The PNN models of the codec's NN policies, per width and QP, and the
decoder's PNN prediction.

The port's copy of the JAX package's `PnnBundle` (`codec/nn_intra.py:30`):
the frozen quantized (integer) models are the normative forward of the
wavefront encoder.  `pair_quantized` optionally holds artifact-trained
("pair") models, which the codec selects over the clean-trained set at
QP >= 32 (`TComPrediction.cpp:155-170`).  A bundle may also carry float
models (`params`, `pair_params`: the JAX package's nested dicts of numpy
arrays); `quantize` freezes them (`models/pnn_q.quantize_pnn` on synthetic
or image calibration contexts) into a bundle whose quantized models the
NN policies run.  A quantized model's architecture is its dict's `kind`
("fc" or "conv"), a float model's its top-level scope.

`context_available`, `extract_context` and `PnnPredictor` (JAX package
:119-264) are the codec's side: one TU's masked context from the
reconstruction so far, and the forward of one context on the predictor's
device.  A width with a quantized model runs the quantized forward
(`models/pnn_q.predict_pixels_q`, op by op; on the card its merger is the
integer merger kernel at N = 1), whose integer sums make it equal to the
wavefront encoder's batched one.  A width with only a float model runs the
float forward (`models/pnn.forward`; on the card the FC kernel or the
float merger kernel at N = 1), then round(clip(pred + mean)), as the JAX
package does (:225-232).  `predict_chroma` runs the luma-trained models on
a 4:2:0 chroma plane (the switch policy's chroma PNNS mode).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..models import pnn, pnn_q, zoo
from ..ops import reference_samples as rs

QP_PAIR_THRESHOLD = 32  # QP >= 32 selects artifact-trained ("pair") models


@dataclass
class PnnBundle:
    """Per-width PNN models + the training mean.

    `mean_training` is one float for every width or a width -> mean dict.
    Quantized model dicts are numpy (`models/pnn_q.load_quantized`, or a
    `quantize_pnn` output); `quantized` may be None in a bundle of float
    models only, which `quantize` turns into one the codec runs."""
    quantized: Optional[Dict[int, dict]]
    mean_training: object              # float | Dict[int, float]
    pair_quantized: Optional[Dict[int, dict]] = None
    params: Optional[Dict[int, dict]] = None        # width -> float params
    pair_params: Optional[Dict[int, dict]] = None

    def params_for_qp(self, qp: int) -> Dict[int, dict]:
        """The float models the codec's QP selects (JAX package :64-72)."""
        if self.pair_params is not None and qp >= QP_PAIR_THRESHOLD:
            # Per-width fallback: widths without a pair model keep the
            # clean-trained one.
            merged = dict(self.params or {})
            merged.update(self.pair_params)
            return merged
        return self.params or {}

    def quantized_for_qp(self, qp: int) -> Dict[int, dict]:
        if self.quantized is None:
            return {}
        if self.pair_quantized is not None and qp >= QP_PAIR_THRESHOLD:
            # Per-width fallback: widths without a pair model keep the
            # clean-trained one.
            merged = dict(self.quantized)
            merged.update(self.pair_quantized)
            return merged
        return self.quantized

    @property
    def is_fully_connected(self) -> Dict[int, bool]:
        """Width -> FC architecture: from the float models where there are
        any, else from the quantized models' kind; the clean-trained model
        before the pair model of its width."""
        out = {}
        for src, is_fc in (
                (self.pair_quantized, _quantized_is_fc),
                (self.quantized, _quantized_is_fc),
                (self.pair_params, _float_is_fc),
                (self.params, _float_is_fc)):
            out.update({w: is_fc(m) for w, m in (src or {}).items()})
        return out

    def quantize(self, calib_images=None, n_samples: int = 256,
                 device="cuda") -> "PnnBundle":
        """A bundle with frozen quantized models for every width of the
        float models (and of the pair models), the float models kept (JAX
        package :77-96).  Each model is calibrated on
        `pnn_q.calibration_contexts` (synthetic with `calib_images=None`)
        and frozen by `pnn_q.quantize_pnn`, whose float forward runs on
        `device`.  Each model is quantized as its own architecture."""
        if not self.params:
            raise ValueError("quantize needs float models (`params`)")

        def build(src):
            out = {}
            for w, p in src.items():
                is_fc = _float_is_fc(p)
                calib = pnn_q.calibration_contexts(
                    w, is_fc, images=calib_images, n_samples=n_samples)
                out[w] = pnn_q.quantize_pnn(p, calib, w, is_fc,
                                            device=device)
            return out

        return PnnBundle(
            build(self.params), self.mean_training,
            pair_quantized=(build(self.pair_params)
                            if self.pair_params is not None else None),
            params=self.params, pair_params=self.pair_params)

    def mean_for(self, n: int) -> float:
        if isinstance(self.mean_training, dict):
            return float(self.mean_training[n])
        return float(self.mean_training)


def _quantized_is_fc(q) -> bool:
    return str(np.asarray(q["kind"])) == "fc"


def _float_is_fc(params) -> bool:
    return "fully_connected" in params


def context_available(x: int, y: int, n: int) -> bool:
    """True iff the anchor pixel (x-n, y-n) lies inside the picture."""
    return x - n >= 0 and y - n >= 0


def extract_context(recon: np.ndarray, x: int, y: int, n: int,
                    flags: np.ndarray, mean_training: float):
    """Masked (above (n,3n), left (2n,n)) float32 context portions.

    `flags` are the reference-sample availability flags in HM line order
    (the same array used for fillReferenceSamples).
    """
    n_units = (2 * n) // 4
    above = np.zeros((n, 3 * n), dtype=np.float32)
    left = np.zeros((2 * n, n), dtype=np.float32)

    # Above-left corner region: always available when contextFlag holds.
    above[:, :n] = recon[y - n:y, x - n:x].astype(np.float32) - mean_training
    # Above / above-right strips gated by the above-unit flags.
    h_limit = recon.shape[0]
    w_limit = recon.shape[1]
    for i in range(n_units):
        if flags[n_units + 1 + i]:
            x0 = x + i * 4
            x1 = min(x0 + 4, w_limit)
            above[:, n + i * 4: n + i * 4 + (x1 - x0)] = (
                recon[y - n:y, x0:x1].astype(np.float32) - mean_training)
    # Left strips, top to bottom; flag order is bottom-to-top.
    for i in range(n_units):
        if flags[n_units - 1 - i]:
            y0 = y + i * 4
            y1 = min(y0 + 4, h_limit)
            left[i * 4: i * 4 + (y1 - y0), :] = (
                recon[y0:y1, x - n:x].astype(np.float32) - mean_training)
    return above, left


def check_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises, so
    an entry point never runs on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           f"is available; pass device='cpu' to run on the "
                           f"CPU")
    return dev


def as_predictor(pnn, device) -> "PnnPredictor":
    """A `PnnPredictor` on `device` from a predictor (its QP and forward
    counts kept) or a `PnnBundle`."""
    if not isinstance(pnn, PnnPredictor):
        return PnnPredictor(pnn, device=device)
    if torch.device(pnn.device) != torch.device(device):
        return PnnPredictor(pnn.bundle, pnn.qp, device,
                            forwards=pnn.forwards,
                            float_forwards=pnn.float_forwards)
    return pnn


@dataclass
class PnnPredictor:
    """Normative PNN prediction of one frame's encode or decode, the
    models on `device` ("cuda" by default).  `forwards` counts the
    quantized forwards run and `float_forwards` the float ones, by
    architecture; cache hits are not forwards."""
    bundle: PnnBundle
    qp: Optional[int] = None   # set by the codec; selects single vs pair models
    device: object = "cuda"
    _models: dict = field(default_factory=dict)  # (width, id) -> tensors
    _cache: dict = field(default_factory=dict)
    forwards: dict = field(default_factory=lambda: {"fc": 0, "conv": 0})
    float_forwards: dict = field(
        default_factory=lambda: {"fc": 0, "conv": 0})

    def bind_qp(self, qp: int) -> "PnnPredictor":
        """Codec-side model selection (QP >= 32 -> pair models when present);
        the models already on the device and the forward counts are
        shared."""
        if self.qp == qp:
            return self
        return PnnPredictor(self.bundle, qp, self.device, self._models,
                            forwards=self.forwards,
                            float_forwards=self.float_forwards)

    @property
    def _quantized(self):
        return self.bundle.quantized_for_qp(self.qp if self.qp is not None
                                            else 0)

    @property
    def _params(self):
        return self.bundle.params_for_qp(self.qp if self.qp is not None
                                         else 0)

    def supports(self, n: int) -> bool:
        return n in self._quantized or n in self._params

    def predict(self, recon: np.ndarray, x: int, y: int, n: int,
                flags: np.ndarray) -> np.ndarray:
        """(n, n) int32 prediction in [0, 255]; zeros if context unavailable."""
        if not context_available(x, y, n) or not self.supports(n):
            return np.zeros((n, n), dtype=np.int32)
        mean = self.bundle.mean_for(n)
        above, left = extract_context(recon, x, y, n, flags, mean)
        return self._forward(above, left, n, mean, (x, y))

    def _on_device(self, n, model, convert):
        key = (n, id(model))
        if key not in self._models:
            self._models[key] = (convert(model, self.device), model)
        return self._models[key][0]

    def _forward(self, above, left, n, mean, pos) -> np.ndarray:
        # The cache key fingerprints the context pixels, not just the
        # position (JAX package :196-201): during RDO the same TU position
        # is predicted under different neighbouring reconstructions.
        key = pos + (n, hash(above.tobytes()) ^ hash(left.tobytes()))
        if key in self._cache:
            return self._cache[key]
        if len(self._cache) > 4096:
            self._cache.clear()
        quant = self._quantized
        if n in quant:
            is_fc = _quantized_is_fc(quant[n])
            params = self._on_device(n, quant[n], pnn_q.params_from_numpy)
        else:
            is_fc = _float_is_fc(self._params[n])
            params = self._on_device(n, self._params[n],
                                     zoo.params_from_numpy)
        if is_fc:
            inputs = torch.from_numpy(np.concatenate(
                [above.reshape(1, -1), left.reshape(1, -1)],
                axis=1)).to(self.device)
        else:
            inputs = (torch.from_numpy(above[None, :, :, None]).to(self.device),
                      torch.from_numpy(left[None, :, :, None]).to(self.device))
        if n in quant:
            out = pnn_q.predict_pixels_q(params, inputs, n, is_fc, mean)
            counts = self.forwards
        else:
            out = pnn.predict_uint8(params, inputs, n, is_fc,
                                    mean).to(torch.int32)
            counts = self.float_forwards
        out = out[0].cpu().numpy()
        counts["fc" if is_fc else "conv"] += 1
        self._cache[key] = out
        return out

    def predict_chroma(self, plane: np.ndarray, unit_coded2: np.ndarray,
                       xc: int, yc: int, nc: int, hc: int,
                       wc: int) -> np.ndarray:
        """Switch chroma PNNS prediction (chroma candidate slot 35, or DM of
        a PNNS luma PU; hm_16_15_switch `TComDataCU.cpp:1364-1400`; JAX
        package :236): the luma-trained models on the chroma plane, as the
        reference's switch codec runs them.  Availability at chroma-unit
        (2-sample) granularity is pooled to the 4-sample units
        `extract_context` expects."""
        if not context_available(xc, yc, nc) or not self.supports(nc):
            return np.zeros((nc, nc), dtype=np.int32)
        c2 = unit_coded2
        pooled = (c2[0::2, 0::2] & c2[0::2, 1::2]
                  & c2[1::2, 0::2] & c2[1::2, 1::2])
        flags = rs.coded_unit_flags(pooled.astype(bool), xc, yc, nc, hc, wc)
        mean = self.bundle.mean_for(nc)
        above, left = extract_context(plane, xc, yc, nc, flags, mean)
        return self._forward(above, left, nc, mean, ("c", xc, yc))

    def invalidate(self):
        self._cache.clear()
