"""Prediction-quality benchmark: PNN vs the best HEVC mode (Tables I-V).

The port of the JAX package's `evaluation/prediction_comparison.py`
(`draw_positions` :51, `hevc_best_mode_predictions` :63,
`compare_on_channels` :96, `write_csv` :179): on test channels, draw
random block positions, and for each validation-mask configuration

* predict each target with the float PNN from its masked context
  (`zoo.predict_by_batch`, on the card through the FC and merger kernels);
* predict it with the best of the 35 HEVC modes (max-PSNR oracle sweep over
  the unmasked causal L, `intra.predict_best_mode` on the device);
* report the mean prediction PSNR and the PNN's win frequency;
* with `ipfcn_params`, also the mean PSNR of the IPFCN-S baseline
  (`models/ipfcn.py`) on the same targets, from its 8-line groups.

Extraction, masking, the pixel rounding and the PSNRs run on the host in
numpy, as in the JAX package.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import extraction, masking
from ..models import zoo
from ..ops import intra
from ..utils import metrics

# The four validation-mask configurations (width_mask_above,
# height_mask_left) of the reference script; "w" is the target width.
DEFAULT_VAL_MASKS = ((0, 0), (0, "w"), ("w", 0), ("w", "w"))


def _resolve_mask(spec, w):
    return w if spec == "w" else int(spec)


@dataclass
class ComparisonRow:
    width_mask_above: int
    height_mask_left: int
    mean_psnr_pnn: float
    mean_psnr_hevc_best: float
    mean_psnr_ipfcn: Optional[float]
    pnn_win_frequency: float


def draw_positions(rng: np.random.Generator, height: int, width: int,
                   width_target: int, nb_positions: int):
    """Positions with full 3w x 3w support inside the channel, drawn
    uniformly in the valid extraction range."""
    hi_r = height - 3 * width_target
    hi_c = width - 3 * width_target
    rows = rng.integers(0, hi_r + 1, nb_positions)
    cols = rng.integers(0, hi_c + 1, nb_positions)
    return rows, cols


def hevc_best_mode_predictions(channel_uint8: np.ndarray, width_target: int,
                               rows: np.ndarray, cols: np.ndarray,
                               targets_uint8: np.ndarray, device="cuda"):
    """Best-of-35-modes predictions from the causal L of each position.

    The intra pattern is built on the host from the row above and the
    column left of the target, at (row_1st + w, col_1st + w), with edge
    replication where the channel ends; the sweep runs on `device`.
    Returns (predictions (N, w, w) uint8, modes (N,)) as numpy."""
    w = width_target
    n = rows.size
    ch = channel_uint8[:, :, 0] if channel_uint8.ndim == 3 else channel_uint8
    ref_top = np.zeros((n, 2 * w + 1), np.int32)
    ref_left = np.zeros((n, 2 * w + 1), np.int32)
    for i in range(n):
        ty, tx = int(rows[i]) + w, int(cols[i]) + w  # target top-left
        ref_top[i, 0] = ch[ty - 1, tx - 1]
        top = ch[ty - 1, tx: tx + 2 * w]
        avail_t = min(2 * w, ch.shape[1] - tx)
        ref_top[i, 1:1 + avail_t] = top[:avail_t]
        if avail_t < 2 * w:
            ref_top[i, 1 + avail_t:] = ref_top[i, avail_t]
        left = ch[ty: ty + 2 * w, tx - 1]
        avail_l = min(2 * w, ch.shape[0] - ty)
        ref_left[i, 0] = ref_top[i, 0]
        ref_left[i, 1:1 + avail_l] = left[:avail_l]
        if avail_l < 2 * w:
            ref_left[i, 1 + avail_l:] = ref_left[i, avail_l]
    dev = torch.device(device)
    best_preds, best_modes, _ = intra.predict_best_mode(
        torch.from_numpy(ref_top).to(dev), torch.from_numpy(ref_left).to(dev),
        torch.from_numpy(np.ascontiguousarray(
            targets_uint8[:, :, :, 0])).to(dev))
    return (best_preds.cpu().numpy().astype(np.uint8),
            best_modes.cpu().numpy())


def ipfcn_groups(channel_uint8: np.ndarray, width_target: int,
                 rows: np.ndarray, cols: np.ndarray):
    """IPFCN-S's (above, left) line groups of each position: the 8-wide
    band hugging the target, origin (target row - 8, target col - 8),
    clamped at the channel's top and left."""
    from ..models import ipfcn

    w = width_target
    out = []
    for r, c in zip(rows, cols):
        rr, cc = max(int(r) + w - 8, 0), max(int(c) + w - 8, 0)
        out.append(ipfcn.extract_pair_groups_lines_from_channel(
            channel_uint8, w, rr, cc))
    return out


def compare_on_channels(channels_uint8: np.ndarray, width_target: int,
                        params: dict, is_fully_connected: bool,
                        mean_training: float, *,
                        nb_positions_per_image: int = 10,
                        val_masks: Sequence = DEFAULT_VAL_MASKS,
                        ipfcn_params: Optional[dict] = None,
                        seed: int = 0, device="cuda"):
    """Runs the comparison on `device`; returns [ComparisonRow] (one per
    mask configuration).  `params` is the nested float param dict of numpy
    arrays (`importer.load_npz_params`, `zoo.load_frozen_params`), carried
    onto `device` in float32; `ipfcn_params` (`ipfcn.import_caffemodel`,
    `ipfcn.load_npz_params`) adds IPFCN-S's mean PSNR to every row."""
    tparams = zoo.params_from_numpy(params, device)
    rng = np.random.default_rng(seed)
    w = width_target
    aboves, lefts, targets, hevc_preds, groups = [], [], [], [], []
    for i in range(channels_uint8.shape[0]):
        ch = channels_uint8[i]
        rows, cols = draw_positions(rng, ch.shape[0], ch.shape[1], w,
                                    nb_positions_per_image)
        if ipfcn_params is not None:
            groups += ipfcn_groups(ch, w, rows, cols)
        a, l, t = extraction.extract_context_portions_targets_from_channel(
            ch, w, rows, cols)
        aboves.append(a)
        lefts.append(l)
        targets.append(t)
        # The HEVC best-mode oracle is mask-independent (the unmasked L).
        hevc_preds.append(hevc_best_mode_predictions(ch, w, rows, cols, t,
                                                     device=device)[0])
    above = np.concatenate(aboves)
    left = np.concatenate(lefts)
    target = np.concatenate(targets)
    psnr_hevc = metrics.compute_psnr_batch(target[:, :, :, 0],
                                           np.concatenate(hevc_preds))

    ipfcn_psnr_mean = None
    if ipfcn_params is not None:
        from ..models import ipfcn

        preds_ip = ipfcn.predict_uint8(
            ipfcn_params, np.stack([g[0] for g in groups]),
            np.stack([g[1] for g in groups]), w, device=device)
        ipfcn_psnr_mean = float(np.mean(
            metrics.compute_psnr_batch(target[:, :, :, 0], preds_ip)))

    rows_out = []
    for mask_spec in val_masks:
        wa = _resolve_mask(mask_spec[0], w)
        hl = _resolve_mask(mask_spec[1], w)
        processed = masking.preprocess_context_portions_targets(
            above, left, target, mean_training, (wa, hl), is_fully_connected)
        if is_fully_connected:
            inputs = processed[0]
        else:
            inputs = (processed[0], processed[1])
        pred = zoo.predict_by_batch(tparams, inputs, w, is_fully_connected)
        pred_u8 = np.clip(np.round(pred[:, :, :, 0] + mean_training), 0, 255
                          ).astype(np.uint8)
        psnr_pnn = metrics.compute_psnr_batch(target[:, :, :, 0], pred_u8)
        rows_out.append(ComparisonRow(
            width_mask_above=wa,
            height_mask_left=hl,
            mean_psnr_pnn=float(psnr_pnn.mean()),
            mean_psnr_hevc_best=float(psnr_hevc.mean()),
            mean_psnr_ipfcn=ipfcn_psnr_mean,
            pnn_win_frequency=float((psnr_pnn > psnr_hevc).mean()),
        ))
    return rows_out


def write_csv(rows: Sequence[ComparisonRow], path_to_csv: str) -> None:
    os.makedirs(os.path.dirname(path_to_csv) or ".", exist_ok=True)
    with open(path_to_csv, "w", newline="") as f:
        writer = csv.writer(f, delimiter=";")
        writer.writerow(["width_mask_above", "height_mask_left",
                         "mean_psnr_pnn", "mean_psnr_hevc_best",
                         "mean_psnr_ipfcn", "pnn_win_frequency"])
        for r in rows:
            writer.writerow([r.width_mask_above, r.height_mask_left,
                             f"{r.mean_psnr_pnn:.4f}",
                             f"{r.mean_psnr_hevc_best:.4f}",
                             "" if r.mean_psnr_ipfcn is None
                             else f"{r.mean_psnr_ipfcn:.4f}",
                             f"{r.pnn_win_frequency:.4f}"])
