"""The comparison that decides `correct`: the port's outputs of a frame
against the plain reference's outputs of the same frame.

The codec is exact (HEVC integer arithmetic; every product of the port
is an integer held exactly), so each number compared counts what
differs and its limit is 0: reconstruction pixels, streams whose bytes
differ, and where the path returns them, decided modes and levels (the
stream carries every decision, PNNS flags and splits included).
"""

from __future__ import annotations

import numpy as np

LIMIT = 0


def exact_checks(outs, refs) -> dict:
    """{name: {"value", "limit"}} over (port outputs, reference outputs)
    pairs of dicts with `recon` and `stream`, and optionally `modes` and
    `levels`."""
    if len(outs) != len(refs):
        raise ValueError(f"{len(outs)} outputs against {len(refs)} "
                         "reference encodes")
    px = streams = 0
    grids = {}
    for out, ref in zip(outs, refs):
        px += int(np.count_nonzero(np.asarray(out["recon"])
                                   != np.asarray(ref["recon"])))
        streams += int(bytes(out["stream"]) != bytes(ref["stream"]))
        for key in ("modes", "levels"):
            if key in ref:
                grids[key] = grids.get(key, 0) + int(np.count_nonzero(
                    np.asarray(out[key]) != np.asarray(ref[key])))
    checks = {"recon_px_differ": {"value": px, "limit": LIMIT}}
    for key, v in grids.items():
        checks[f"{key}_differ"] = {"value": v, "limit": LIMIT}
    checks["streams_differ"] = {"value": streams, "limit": LIMIT}
    return checks
