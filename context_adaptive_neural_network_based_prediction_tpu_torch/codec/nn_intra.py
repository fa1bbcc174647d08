"""The PNN models of the codec's NN policies, per width and QP, and the
decoder's PNN prediction.

The port's copy of the JAX package's `PnnBundle` (`codec/nn_intra.py:30`),
without the float models: the frozen quantized (integer) models are the
normative forward of the wavefront encoder.  `pair_quantized` optionally
holds artifact-trained ("pair") models, which the codec selects over the
clean-trained set at QP >= 32 (`TComPrediction.cpp:155-170`).  A model's
architecture is its dict's `kind` ("fc" or "conv").

`context_available`, `extract_context` and `PnnPredictor` (JAX package
:119-234) are the decoder's side: one TU's masked context from the
reconstruction so far, and the quantized forward of one context
(`models/pnn_q.predict_pixels_q`, op by op, on the predictor's device; on
the card its merger is the integer merger kernel at N = 1).  Integer sums
make that forward equal to the encoder's batched one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..models import pnn_q

QP_PAIR_THRESHOLD = 32  # QP >= 32 selects artifact-trained ("pair") models


@dataclass
class PnnBundle:
    """Per-width quantized PNN models + the training mean.

    `mean_training` is one float for every width or a width -> mean dict.
    Model dicts are numpy (`models/pnn_q.load_quantized`, or the JAX
    package's `quantize_pnn` output)."""
    quantized: Dict[int, dict]
    mean_training: object              # float | Dict[int, float]
    pair_quantized: Optional[Dict[int, dict]] = None

    def quantized_for_qp(self, qp: int) -> Dict[int, dict]:
        if self.pair_quantized is not None and qp >= QP_PAIR_THRESHOLD:
            # Per-width fallback: widths without a pair model keep the
            # clean-trained one.
            merged = dict(self.quantized)
            merged.update(self.pair_quantized)
            return merged
        return self.quantized

    @property
    def is_fully_connected(self) -> Dict[int, bool]:
        """Width -> FC architecture, from the clean-trained models' kind
        (pair-only widths from the pair model)."""
        out = {w: str(np.asarray(q["kind"])) == "fc"
               for w, q in (self.pair_quantized or {}).items()}
        out.update({w: str(np.asarray(q["kind"])) == "fc"
                    for w, q in self.quantized.items()})
        return out

    def mean_for(self, n: int) -> float:
        if isinstance(self.mean_training, dict):
            return float(self.mean_training[n])
        return float(self.mean_training)


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


@dataclass
class PnnPredictor:
    """Normative PNN prediction of one frame's decode, quantized models on
    `device` ("cuda" by default).  `forwards` counts the forwards run by
    architecture (cache hits are not forwards)."""
    bundle: PnnBundle
    qp: Optional[int] = None   # set by the codec; selects single vs pair models
    device: object = "cuda"
    _models: dict = field(default_factory=dict)  # (width, pair) -> tensors
    _cache: dict = field(default_factory=dict)
    forwards: dict = field(default_factory=lambda: {"fc": 0, "conv": 0})

    def bind_qp(self, qp: int) -> "PnnPredictor":
        """Codec-side model selection (QP >= 32 -> pair models when present);
        the models already on the device are shared."""
        if self.qp == qp:
            return self
        return PnnPredictor(self.bundle, qp, self.device, self._models)

    @property
    def _quantized(self):
        return self.bundle.quantized_for_qp(self.qp if self.qp is not None
                                            else 0)

    def supports(self, n: int) -> bool:
        if n in self._quantized:
            return True
        float_models = getattr(self.bundle, "params", None) or {}
        if n in float_models:
            raise NotImplementedError(
                f"width {n} has only a float PNN; the port's decoder runs the"
                f" quantized models (the float fallback is ROADMAP A9)")
        return False

    def predict(self, recon: np.ndarray, x: int, y: int, n: int,
                flags: np.ndarray) -> np.ndarray:
        """(n, n) int32 prediction in [0, 255]; zeros if context unavailable."""
        if not context_available(x, y, n) or not self.supports(n):
            return np.zeros((n, n), dtype=np.int32)
        mean = self.bundle.mean_for(n)
        above, left = extract_context(recon, x, y, n, flags, mean)
        return self._forward(above, left, n, mean, (x, y))

    def _forward(self, above, left, n, mean, pos) -> np.ndarray:
        # The cache key fingerprints the context pixels, not just the
        # position (JAX package :196-201).
        key = pos + (n, hash(above.tobytes()) ^ hash(left.tobytes()))
        if key in self._cache:
            return self._cache[key]
        if len(self._cache) > 4096:
            self._cache.clear()
        q = self._quantized[n]
        is_fc = str(np.asarray(q["kind"])) == "fc"
        mkey = (n, id(q))
        if mkey not in self._models:
            self._models[mkey] = (pnn_q.params_from_numpy(q, self.device), q)
        params = self._models[mkey][0]
        if is_fc:
            inputs = torch.from_numpy(np.concatenate(
                [above.reshape(1, -1), left.reshape(1, -1)],
                axis=1)).to(self.device)
        else:
            inputs = (torch.from_numpy(above[None, :, :, None]).to(self.device),
                      torch.from_numpy(left[None, :, :, None]).to(self.device))
        out = pnn_q.predict_pixels_q(params, inputs, n, is_fc,
                                     mean)[0].cpu().numpy()
        self.forwards["fc" if is_fc else "conv"] += 1
        self._cache[key] = out
        return out

    def invalidate(self):
        self._cache.clear()
