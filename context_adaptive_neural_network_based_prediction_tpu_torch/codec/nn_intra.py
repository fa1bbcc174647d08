"""The PNN models of the codec's NN policies, per width and QP.

The port's copy of the JAX package's `PnnBundle` (`codec/nn_intra.py:30`),
without the float models: the frozen quantized (integer) models are the
normative forward of the wavefront encoder.  `pair_quantized` optionally
holds artifact-trained ("pair") models, which the codec selects over the
clean-trained set at QP >= 32 (`TComPrediction.cpp:155-170`).  A model's
architecture is its dict's `kind` ("fc" or "conv").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

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
