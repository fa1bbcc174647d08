"""The float prediction path held against the JAX package's goldens.

`tests/golden_torch/float_pnn.npz` and `float_pnn.json`, written by
`scripts/capture_torch_port_golden.py --set float`, hold what the JAX
package computes on the 128x128 natural test frame
(`tests/golden_hm/128_full_q32_src.npy`) for each float single of the
chip copy (`MODELS`): the positions and per-example masks of seeded
contexts, the sha256 of the masked float32 contexts, `pnn.forward` on
them, the interpret-mode outputs of the two Pallas kernels with bf16
weights, and the `compare_on_channels` rows.  The checks here run the
port's own path on a device and report its distance to them; the card
tests (`tests/test_torch_cuda.py`) and `chip_smoke.py`, which have no JAX,
hold the distances to their tolerances.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from ..data import extraction, masking
from ..models import pnn, zoo
from ..ops import fc_forward as fc_ops
from ..ops import merger as merger_ops
from . import prediction_comparison as pc

MODELS = ("pnn_w4_fc_single", "pnn_w8_fc_single", "pnn_w4_refconv_single",
          "pnn_w8_refconv_single", "pnn_w16_single", "pnn_w32_single")
GOLDEN = os.path.join("tests", "golden_torch", "float_pnn")
FRAME = os.path.join("tests", "golden_hm", "128_full_q32_src.npy")


def model_width(name: str) -> int:
    return int(name.split("_")[1][1:])


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def load(repo: str) -> dict:
    """{"repo", "meta" (the JSON), "arrays" (the npz as numpy)}."""
    with open(os.path.join(repo, GOLDEN + ".json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(repo, GOLDEN + ".npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return {"repo": repo, "meta": meta, "arrays": arrays}


def natural_channels(repo: str) -> np.ndarray:
    """The natural test frame as one (1, H, W, 1) uint8 channel."""
    return np.load(os.path.join(repo, FRAME))[None, :, :, None]


def _model(golden, name):
    return zoo.load_frozen_params(os.path.join(
        golden["repo"], "artifacts", "frozen", name + ".npz"))


def contexts(golden: dict, name: str):
    """The port's extraction and masking at the golden's positions and
    masks: (inputs as numpy (flat, or (above, left)), sha of the masked
    float32 contexts)."""
    a = golden["arrays"]
    m = golden["meta"]["models"][name]
    w = model_width(name)
    ch = natural_channels(golden["repo"])[0]
    above, left, target = \
        extraction.extract_context_portions_targets_from_channel(
            ch, w, a[f"rows/{name}"], a[f"cols/{name}"])
    masks = a[f"masks/{name}"]
    proc = masking.preprocess_context_portions_targets(
        above, left, target, golden["meta"]["mean"],
        (masks[:, 0], masks[:, 1]), m["is_fc"])
    inputs = proc[0] if m["is_fc"] else (proc[0], proc[1])
    digest = sha(proc[0]) if m["is_fc"] else sha(proc[0]) + sha(proc[1])
    return inputs, digest


def check_model(golden: dict, name: str, device) -> dict:
    """The port's forward (float32 weights) on the golden contexts:
    {"forward_rel_err": max |port - JAX| / max |JAX|, "contexts_equal",
    "n"}."""
    m = golden["meta"]["models"][name]
    params, is_fc = _model(golden, name)
    inputs, digest = contexts(golden, name)
    tparams = zoo.params_from_numpy(params, device)
    got = zoo.predict_by_batch(tparams, inputs, model_width(name), is_fc)
    want = golden["arrays"][f"forward/{name}"]
    err = float(np.abs(got.astype(np.float64) - want).max()
                / np.abs(want).max())
    return {"forward_rel_err": err, "contexts_equal": digest == m["sha"],
            "n": int(want.shape[0])}


def check_comparison(golden: dict, name: str, device) -> dict:
    """`compare_on_channels` on the natural frame with the golden's
    settings: {"max_psnr_diff" (dB, PNN and HEVC columns), "max_win_diff",
    "n" (positions), "rows"}."""
    c = golden["meta"]["compare"][name]
    params, is_fc = _model(golden, name)
    rows = pc.compare_on_channels(
        natural_channels(golden["repo"]), model_width(name), params, is_fc,
        golden["meta"]["mean"], nb_positions_per_image=c["nb_positions"],
        seed=c["seed"], device=device)
    d_psnr = d_win = 0.0
    for r, want in zip(rows, c["rows"]):
        if (r.width_mask_above, r.height_mask_left) != (
                want["width_mask_above"], want["height_mask_left"]):
            raise AssertionError(f"{name}: mask rows out of order")
        d_psnr = max(d_psnr, abs(r.mean_psnr_pnn - want["mean_psnr_pnn"]),
                     abs(r.mean_psnr_hevc_best
                         - want["mean_psnr_hevc_best"]))
        d_win = max(d_win, abs(r.pnn_win_frequency
                               - want["pnn_win_frequency"]))
    return {"max_psnr_diff": d_psnr, "max_win_diff": d_win,
            "n": c["nb_positions"], "rows": rows}


def check_pallas(golden: dict, device) -> dict:
    """The two kernels' wrappers with bfloat16 weights against the JAX
    package's interpret-mode Pallas kernels: {key: max |port - Pallas| /
    max |Pallas|}."""
    a = golden["arrays"]
    out = {}
    for key, spec in golden["meta"]["pallas"].items():
        name = spec["model"]
        params, _ = _model(golden, name)
        tp = zoo.params_from_numpy(params, device, torch.bfloat16)
        if spec["kind"] == "fc":
            fc = tp["fully_connected"]
            x = torch.from_numpy(a[f"pallas/{key}/x"]).to(device)
            got = fc_ops.fc_forward(x, [fc[f"weights_{i}"] for i in range(4)],
                                    [fc[f"biases_{i}"] for i in range(4)])
        else:
            cm = tp["convolutional"]["merger"][
                "channelwise_fully_connected_merger"]
            x = torch.from_numpy(a[f"pallas/{key}/x"]).to(device)
            got = merger_ops.merger_forward(x, cm["weights"], cm["biases"],
                                            act=True)
        want = a[f"pallas/{key}/out"]
        got = got.cpu().numpy().reshape(want.shape)
        out[key] = float(np.abs(got.astype(np.float64) - want).max()
                         / np.abs(want).max())
    return out


def forward_launches(name: str, n: int, batch_size: int = 1024) -> dict:
    """Kernel launches of one `predict_by_batch` over n examples:
    {("fc", (K, D)): count} for an FC model, {("merger", M): count} for a
    conv model."""
    chunks = -(-n // batch_size)
    w = model_width(name)
    if "_fc_" in name:
        dims = [(5 * w * w, pnn.HIDDEN_FC), (pnn.HIDDEN_FC, pnn.HIDDEN_FC),
                (pnn.HIDDEN_FC, pnn.HIDDEN_FC), (pnn.HIDDEN_FC, w * w)]
        counts: dict = {}
        for d in dims:
            counts[("fc", d)] = counts.get(("fc", d), 0) + chunks
        return counts
    strides = pnn.STRIDES_BRANCH[w]
    return {("merger", pnn._branch_layer_maps(strides)[-1]): chunks}
