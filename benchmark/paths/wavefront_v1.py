"""The port's v1 uniform-grid wavefront encoder (`parallel/wavefront.
encode_frames_wavefront_batch`): every n x n block its own CU with HM's
35 modes, `batch` frames on the slot axis of one device run, then each
frame's container stream packed on the host by `codec/native.
serialize_grid`, as `wavefront._result` packs it.  No kernel of the port
runs on this path.

The comparison re-encodes a seeded sample of the window's frames with
the plain reference (`reference/wavefront_v1.py`) and holds the port's
reconstruction, modes, levels and stream against it, exactly.
"""

from __future__ import annotations

import importlib
import time

import numpy as np

from benchmark import compare as cmp
from benchmark import frames as frames_mod
from benchmark import geometry

PORT = "context_adaptive_neural_network_based_prediction_tpu_torch"


class Cell:
    def __init__(self, config, traffic, seed, device, root):
        self.wf = importlib.import_module(f"{PORT}.parallel.wavefront")
        self.native = importlib.import_module(f"{PORT}.codec.native")
        self.device = device
        self.h, self.w = traffic["height"], traffic["width"]
        self.batch = traffic["batch"]
        self.qp, self.n = config["qp"], config["block_size"]
        self.native.load_library()
        self.frames = frames_mod.make_frames(
            seed, 2 * self.batch, self.h, self.w, device)
        self.steps, _, _ = geometry.schedule(self.h // self.n,
                                             self.w // self.n)

    def inputs(self, k):
        s = (k % 2) * self.batch
        return self.frames[s:s + self.batch]

    def warm_up(self):
        self.call(0)

    def _device_half(self, k):
        return self.wf.encode_frames_wavefront_batch(
            self.inputs(k), self.qp, block_size=self.n, device=self.device)

    def _pack(self, modes, levels):
        return [self.native.serialize_grid(
            modes[f], levels[f], width=self.w, height=self.h, n=self.n,
            qp=self.qp) for f in range(len(modes))]

    def call(self, k):
        recons, modes, levels = self._device_half(k)
        streams = self._pack(modes, levels)
        return [{"recon": recons[f], "modes": modes[f], "levels": levels[f],
                 "stream": streams[f]} for f in range(len(streams))]

    def split_call(self, k):
        t0 = time.perf_counter()
        _, modes, levels = self._device_half(k)
        t1 = time.perf_counter()
        self._pack(modes, levels)
        t2 = time.perf_counter()
        return {"device_half_s": t1 - t0, "host_pack_s": t2 - t1,
                "call_s": t2 - t0}

    def layer_spans(self):
        return {}

    def least_s(self, rates):
        return {}

    def release(self):
        # The port keeps its plans' device tensors in a module cache; they
        # are freed before the reference runs.
        getattr(self.wf, "_PLAN_CACHE", {}).clear()


def compare(config, traffic, pairs, device):
    """Holds (input frame, the port's outputs) pairs against the plain
    reference's encodes of the same frames (limit 0: the codec is
    exact)."""
    from benchmark.reference import wavefront_v1 as ref

    frames = np.stack([f for f, _ in pairs])
    refs = ref.encode_frames(frames, config, device)
    return cmp.exact_checks([out for _, out in pairs], refs)
