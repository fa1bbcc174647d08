"""Seeded luma frames with natural-image statistics.

A seeded rewrite of `bench.py`'s synthetic frame (a level, two
sinusoidal textures and Gaussian noise), widened to what natural content
has: a gradient, textures whose periods and phases vary from frame to
frame, rectangular objects whose edges cut across CTBs, and noise of a
drawn strength.  Every seed gives frames of the same size and the same
kinds of content in other amounts and places.  The frames are made on
the run's device with one `torch.Generator` in a few large calls; the
same seed on the same kind of device gives the same frames.
"""

from __future__ import annotations

import numpy as np
import torch

N_OBJECTS = 8          # rectangles a frame
CHUNK = 16             # frames made at once (bounds the temporaries)


def make_frames(seed: int, count: int, height: int, width: int,
                device) -> np.ndarray:
    """(count, height, width) uint8 frames from `seed`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = np.empty((count, height, width), np.uint8)
    yy = torch.arange(height, device=device, dtype=torch.float32)
    xx = torch.arange(width, device=device, dtype=torch.float32)
    for c0 in range(0, count, CHUNK):
        k = min(CHUNK, count - c0)
        u = torch.rand((k, 10), generator=gen, device=device)
        boxes = torch.rand((k, N_OBJECTS, 5), generator=gen, device=device)
        noise = torch.randn((k, height, width), generator=gen, device=device)
        col = lambda j: u[:, j, None, None]
        # bench.py's frame: 120 + 50 sin(x / 17) + 35 cos(y / 23) + N(0, 5).
        f = (90.0 + 60.0 * col(0)
             + (30.0 + 40.0 * col(1)) * torch.sin(
                 xx[None, None, :] / (10.0 + 14.0 * col(2)) + 6.3 * col(3))
             + (20.0 + 30.0 * col(4)) * torch.cos(
                 yy[None, :, None] / (14.0 + 18.0 * col(5)) + 6.3 * col(6))
             + (col(7) - 0.5) * 0.06 * xx[None, None, :]
             + (col(8) - 0.5) * 0.06 * yy[None, :, None]
             + (2.0 + 8.0 * col(9)) * noise)
        for j in range(N_OBJECTS):
            bx = boxes[:, j]
            y0 = (bx[:, 0] * height)[:, None, None]
            x0 = (bx[:, 1] * width)[:, None, None]
            hh = (0.05 + 0.3 * bx[:, 2] * height)[:, None, None]
            ww = (0.05 + 0.3 * bx[:, 3] * width)[:, None, None]
            inside = ((yy[None, :, None] >= y0) & (yy[None, :, None] < y0 + hh)
                      & (xx[None, None, :] >= x0)
                      & (xx[None, None, :] < x0 + ww))
            f = torch.where(inside, f + (bx[:, 4] - 0.5)[:, None, None]
                            * 120.0, f)
        out[c0:c0 + k] = torch.clamp(torch.round(f), 0, 255).to(
            torch.uint8).cpu().numpy()
    return out
