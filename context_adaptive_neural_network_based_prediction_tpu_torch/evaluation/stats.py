"""Intra-mode usage statistics (numpy, on the host).

The port's copy of the JAX package's `evaluation/stats.py` (the
reference's `hevc/stats.py`, `collecting_stats_hevc_modes.py`): per TB
width, how often each mode wins the rate-distortion selection, counted
from the port's `EncodeResult.ctu_trees`; the parser of the instrumented
HM encoder's beacon files; and the two bar plots (matplotlib, imported
when a plot is drawn).

Widths tracked: {4, 8, 16, 32, 64}; modes 0..35 (35 = PNNS under the switch
policy).  The reference QP protocol for this experiment is
QPS_STATS = (22, 27, 32, 37, 42) (`collecting_stats_hevc_modes.py:319-320`).
"""

from __future__ import annotations

import numpy as np

QPS_STATS = (22, 27, 32, 37, 42)
WIDTHS = (4, 8, 16, 32, 64)
NB_MODES_MAX = 36


def collect_mode_counts(encode_result) -> np.ndarray:
    """(len(WIDTHS), 36) int64 histogram of RD-winning modes per PU width."""
    counts = np.zeros((len(WIDTHS), NB_MODES_MAX), dtype=np.int64)
    w_index = {w: i for i, w in enumerate(WIDTHS)}

    def walk(node):
        if node is None:
            return
        if node.split:
            for c in node.children:
                walk(c)
            return
        for pu in node.pus:
            counts[w_index[pu.n], pu.mode] += 1

    for tree in encode_result.ctu_trees:
        walk(tree)
    return counts


def counts_to_ratios(counts: np.ndarray) -> np.ndarray:
    """Row-normalized frequencies (rows with no samples stay zero)."""
    totals = counts.sum(axis=1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        ratios = np.where(totals > 0, counts / totals, 0.0)
    return ratios


def accumulate_over_images(results) -> np.ndarray:
    total = np.zeros((len(WIDTHS), NB_MODES_MAX), dtype=np.int64)
    for r in results:
        total += collect_mode_counts(r)
    return total


# ------------------------------------------------------------------ HM side

# The instrumented HM-16.15 "regular" encoder (reference N9) prints beacon
# lines per frame into --PathToStats files; format produced by
# TEncGOP.cpp:1895-1967, consumed by the reference's hevc/stats.py:57-226.
# Each matching line is "<beacon0> <mode-index> <beacon1> i4 i8 i16 i32 i64".
BEACON_PAIRS = (("index", "wins the fast selection:"),
                ("index", "wins the rate-distortion selection:"),
                ("index", "is found in the fast list:"))
BEACON_RUN = "{fast selection, rate-distortion selection} is run:"


def _ints_after(line: str, beacon: str):
    tail = line.split(beacon, 1)[1].strip()
    return [int(t) for t in tail.split()] if tail else []


def parse_hm_stats_file(path: str, nb_modes: int = 35):
    """Parses one HM beacon-format stats file.

    Returns (counts (len(BEACON_PAIRS), nb_modes, 5) int64,
    runs (5,) int64) - per-mode indicators for each beacon pair plus the
    pipeline run count, per TB width {4,8,16,32,64}.
    """
    counts = np.zeros((len(BEACON_PAIRS), nb_modes, len(WIDTHS)), np.int64)
    runs = np.zeros(len(WIDTHS), np.int64)
    with open(path, "r") as f:
        for line in f:
            if BEACON_RUN in line:
                vals = _ints_after(line, BEACON_RUN)
                if len(vals) >= len(WIDTHS):
                    runs += np.array(vals[:len(WIDTHS)], np.int64)
                continue
            for k, (b0, b1) in enumerate(BEACON_PAIRS):
                if b0 in line and b1 in line:
                    between = line.split(b0, 1)[1].split(b1, 1)[0].split()
                    if not between:
                        continue
                    try:
                        mode = int(between[0])
                    except ValueError:
                        continue
                    vals = _ints_after(line, b1)
                    if 0 <= mode < nb_modes and len(vals) >= len(WIDTHS):
                        counts[k, mode] += np.array(vals[:len(WIDTHS)],
                                                    np.int64)
                    break
    return counts, runs


def collect_hm_beacon_stats(frames, qp: int, nb_modes: int = 35,
                            config=None):
    """Encodes luma frames with the instrumented stock HM encoder
    (--PathToStats) and accumulates the parsed beacon statistics.

    Returns (counts (3, nb_modes, 5), runs (5,)) summed over frames.
    Requires the committed HM binaries (`hm_driver.hm_binary`) and HM's
    encoder config (`config`, not in the repository).
    """
    import tempfile

    from . import hm_driver

    enc = hm_driver.hm_binary("TAppEncoderStatic")
    if enc is None:
        raise FileNotFoundError("HM TAppEncoderStatic not found "
                                "(artifacts/hm_bin or $HM_BIN_DIR)")
    paths = hm_driver.HmPaths(encoder=enc, config=config)
    counts = np.zeros((len(BEACON_PAIRS), nb_modes, len(WIDTHS)), np.int64)
    runs = np.zeros(len(WIDTHS), np.int64)
    for frame in frames:
        with tempfile.NamedTemporaryFile(suffix=".txt") as tf:
            hm_driver.encode_decode_with_hm(
                frame, qp, paths,
                extra_args=(f"--PathToStats={tf.name}",))
            c, r = parse_hm_stats_file(tf.name, nb_modes)
        counts += c
        runs += r
    return counts, runs


def hm_rd_win_counts(frames, qp: int, nb_modes: int = 35,
                     config=None) -> np.ndarray:
    """HM's RD-selection-win histogram shaped like `collect_mode_counts`:
    (len(WIDTHS), NB_MODES_MAX) - widths on rows, modes on columns."""
    counts, _ = collect_hm_beacon_stats(frames, qp, nb_modes, config)
    out = np.zeros((len(WIDTHS), NB_MODES_MAX), np.int64)
    out[:, :nb_modes] = counts[1].T
    return out


def plot_mode_frequencies_vs_hm(ours: np.ndarray, hm: np.ndarray,
                                path_to_png: str, title: str = "") -> None:
    """Tables VI-VIII-style comparison: our codec's and HM's RD-win mode
    frequencies per width on one axis (side-by-side bars)."""
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    r_ours = counts_to_ratios(ours)
    r_hm = counts_to_ratios(hm)
    active = [i for i in range(len(WIDTHS))
              if ours[i].sum() > 0 or hm[i].sum() > 0]
    fig, axes = plt.subplots(len(active), 1,
                             figsize=(10, 2.4 * len(active)), squeeze=False)
    x = np.arange(NB_MODES_MAX)
    for ax_i, wi in enumerate(active):
        ax = axes[ax_i][0]
        ax.bar(x - 0.2, r_ours[wi], width=0.4, label="ours")
        ax.bar(x + 0.2, r_hm[wi], width=0.4, label="HM-16.15")
        ax.set_ylabel(f"{WIDTHS[wi]}x{WIDTHS[wi]}")
        ax.set_xlim(-1, NB_MODES_MAX)
        if ax_i == 0:
            ax.legend(loc="upper right")
    axes[-1][0].set_xlabel("intra mode (35 = PNNS)")
    fig.suptitle(title)
    os.makedirs(os.path.dirname(path_to_png) or ".", exist_ok=True)
    fig.savefig(path_to_png, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_mode_frequencies(counts: np.ndarray, path_to_png: str,
                          title: str = "") -> None:
    """Bar plots of mode win frequencies per width (reference-style)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ratios = counts_to_ratios(counts)
    active = [i for i, w in enumerate(WIDTHS) if counts[i].sum() > 0]
    fig, axes = plt.subplots(len(active), 1, figsize=(10, 2.4 * len(active)),
                             squeeze=False)
    for ax_i, wi in enumerate(active):
        ax = axes[ax_i][0]
        ax.bar(np.arange(NB_MODES_MAX), ratios[wi])
        ax.set_ylabel(f"{WIDTHS[wi]}x{WIDTHS[wi]}")
        ax.set_xlim(-1, NB_MODES_MAX)
    axes[-1][0].set_xlabel("intra mode (35 = PNNS)")
    fig.suptitle(title)
    import os

    os.makedirs(os.path.dirname(path_to_png) or ".", exist_ok=True)
    fig.savefig(path_to_png, dpi=120, bbox_inches="tight")
    plt.close(fig)
