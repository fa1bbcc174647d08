"""Driver for the HM-16.15 binaries (the reference's subprocess layer).

The port's copy of the JAX package's `evaluation/hm_driver.py` (the
reference's `hevc/running.py`, `hevc/performance.py`,
`hevc/unifiedloading.py`): write raw YUV, run HM's encoder, parse its log
for bits, PSNR and "Total Time", read the reconstruction back, clean up;
and `load_luminance`, the first luma frame of a .yuv sequence or an
image file.  All on the host.

Two differences from the JAX package: `HmPaths.config` has no default
(the JAX package's names HM's `intra_main_rext.cfg` outside the
repository, which is not shipped with it; an encode without a config
raises), and `hm_binary` looks in `$HM_BIN_DIR` and the repository's
`artifacts/hm_bin/` only.
"""

from __future__ import annotations

import os
import re
import subprocess
import tempfile
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..utils import color, images, yuv

# Known CTC / xiph sequence geometry (reference hevc/unifiedloading.py:10-37).
DICTIONARY_DESCRIPTION: Dict[str, tuple] = {
    "D_BasketballPass": (240, 416),
    "C_BasketballDrill": (480, 832),
    "B_Kimono": (1080, 1920),
    "B_ParkScene": (1080, 1920),
    "B_Cactus": (1080, 1920),
}


@dataclass
class HmPaths:
    encoder: str
    decoder: Optional[str] = None
    config: Optional[str] = None        # HM's intra_main_rext.cfg


def hm_binary(name: str) -> Optional[str]:
    """An HM-16.15 executable (e.g. "TAppDecoderStatic"): `$HM_BIN_DIR`,
    then the copies committed under `artifacts/hm_bin/`; None when it is
    in neither."""
    candidates = []
    if os.environ.get("HM_BIN_DIR"):
        candidates.append(os.path.join(os.environ["HM_BIN_DIR"], name))
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    candidates.append(os.path.join(repo_root, "artifacts", "hm_bin", name))
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    return None


@dataclass
class HmResult:
    rate_bpp: float
    psnr_y_db: float
    total_time_s: float
    reconstruction: np.ndarray


def load_luminance(path: str, height: Optional[int] = None,
                   width: Optional[int] = None) -> np.ndarray:
    """First luma frame from .yuv (given dims or a known sequence name) or
    an image file, cropped to a multiple of 8 (reference
    unifiedloading.py)."""
    name = os.path.basename(path)
    if path.endswith(".yuv"):
        if height is None:
            for key, (h, w) in DICTIONARY_DESCRIPTION.items():
                if key.split("_", 1)[1].lower() in name.lower():
                    height, width = h, w
                    break
        if height is None:
            raise ValueError("unknown sequence; pass height/width")
        video = yuv.read_400_or_420(height, width, 1, np.uint8, False, path)
        luma = video[:, :, 0, 0]
    else:
        try:
            arr = images.read_image_mode(path, "RGB")
            luma = color.rgb_to_ycbcr(arr)[:, :, 0]
        except ValueError:
            luma = images.read_image_mode(path, "L")
    return luma[: (luma.shape[0] // 8) * 8, : (luma.shape[1] // 8) * 8]


def encode_decode_with_hm(luminance_uint8: np.ndarray, qp: int,
                          paths: HmPaths, *, extra_args=()) -> HmResult:
    """One luma frame through HM's encoder (4:0:0, 8 bits, one frame at
    `qp`) with `paths.config`; raises if the config is missing or HM
    fails."""
    if not paths.config or not os.path.isfile(paths.config):
        raise FileNotFoundError(
            f"HM encoder config {paths.config!r} not found: HM's "
            f"intra_main_rext.cfg is not in the repository; pass its path "
            f"as HmPaths(config=...)")
    h, w = luminance_uint8.shape
    with tempfile.TemporaryDirectory() as tmp:
        yuv_in = os.path.join(tmp, "in.yuv")
        bin_out = os.path.join(tmp, "out.bin")
        rec_out = os.path.join(tmp, "rec.yuv")
        yuv.write_400_or_420(luminance_uint8[:, :, None, None], yuv_in)
        cmd = [paths.encoder, "-c", paths.config,
               "-i", yuv_in, "-b", bin_out, "-o", rec_out,
               "-wdt", str(w), "-hgt", str(h),
               "--InputBitDepth=8", "--InputChromaFormat=400",
               "--FramesToBeEncoded=1", f"--QP={qp}", *extra_args]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
        log = proc.stdout
        n_bytes = os.path.getsize(bin_out)
        m_time = re.search(r"Total Time:\s+([0-9.]+)", log)
        m_psnr = re.search(r"1\s+i\s+[0-9.]+\s+([0-9.]+)", log)
        rec = yuv.read_400_or_420(h, w, 1, np.uint8, True, rec_out)[:, :, 0, 0]
        return HmResult(
            rate_bpp=n_bytes * 8 / (h * w),
            psnr_y_db=float(m_psnr.group(1)) if m_psnr else float("nan"),
            total_time_s=float(m_time.group(1)) if m_time else float("nan"),
            reconstruction=rec,
        )
