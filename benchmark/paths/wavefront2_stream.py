"""The port's streaming wavefront2 encoder (`parallel/wavefront2.
encode_stream_wavefront2`): CTB 32 quadtree, NxN on, rate evolution on,
under the configuration's policy (regular, or switch with the quantized
PNN zoo as a signalled 36th mode), `batch` frames interleaved into one
device run, each frame's CABAC pack on the host after the run.

The timed call feeds one batch of frames and takes back a stream and a
reconstruction for each.  The comparison re-encodes a seeded sample of
the window's frames with the plain reference (`reference/wavefront2.py`)
and holds the port's reconstruction and stream against it, exactly.
"""

from __future__ import annotations

import importlib
import os
import time

import numpy as np
import torch

from benchmark import compare as cmp
from benchmark import frames as frames_mod
from benchmark import geometry, roofline

PORT = "context_adaptive_neural_network_based_prediction_tpu_torch"
CTB = 32
# Units of each size in one CTB 32 (NxN on): the trial launches and PNN
# forwards a step makes per width, in the sub-stage order of a CTB.
UNITS_PER_CTB = {4: 64, 8: 16, 16: 4, 32: 1}
PNN_STEP_REPS = 3


class Cell:
    def __init__(self, config, traffic, seed, device, root):
        port = lambda m: importlib.import_module(f"{PORT}.{m}")
        self.w2 = port("parallel.wavefront2")
        self.native, self.enc = port("codec.native"), port("codec.encoder")
        self.pnn_q = port("models.pnn_q")
        self.config, self.device = config, device
        self.h, self.w = traffic["height"], traffic["width"]
        self.batch = traffic["batch"]
        self.qp, self.policy = config["qp"], config["policy"]
        if device.type == "cuda":
            port("ops._cuda_build").load()
            self.native.load_library()
        self.zoo = None
        if config.get("manifest"):
            self.zoo = port("models.zoo").load_quantized_bundle(
                os.path.join(root, config["manifest"]),
                config["mean_training"], use_pair=False,
                widths=tuple(config["pnn_widths"]))
        self.frames = frames_mod.make_frames(
            seed, 2 * self.batch, self.h, self.w, device)
        self.nby, self.nbx = self.h // CTB, self.w // CTB
        self.steps, _, self.valid = geometry.schedule(self.nby, self.nbx)

    def _kw(self):
        return dict(policy=self.policy, pnn=self.zoo, ctb=CTB,
                    enable_nxn=True, rate_evolve=True, device=self.device)

    def inputs(self, k):
        s = (k % 2) * self.batch
        return self.frames[s:s + self.batch]

    def warm_up(self):
        self.call(0)

    def call(self, k):
        res = list(self.w2.encode_stream_wavefront2(
            list(self.inputs(k)), self.qp, batch=self.batch, **self._kw()))
        return [{"recon": r.reconstruction, "stream": r.bitstream}
                for r in res]

    def split_call(self, k):
        """Host seconds of the public device half of one batch (it ends with
        the decided grids on the host) and of the CABAC pack of its
        frames."""
        frames = self.inputs(k)
        t0 = time.perf_counter()
        out = self.w2.encode_arrays_wavefront2_batch(frames, self.qp,
                                                     **self._kw())
        t1 = time.perf_counter()
        for _, grids in out:
            self.enc.stream_header(width=self.w, height=self.h, qp=self.qp,
                                   policy=self.policy, ctu_size=CTB,
                                   sign_hiding=True) \
                + self.native.pack_tree_payload(
                    grids, width=self.w, height=self.h, qp=self.qp,
                    ctu_size=CTB, policy=self.policy)
        t2 = time.perf_counter()
        return {"device_half_s": t1 - t0, "host_pack_s": t2 - t1,
                "call_s": t2 - t0}

    def _pnn_models(self):
        if self.zoo is None:
            return {}
        return {w: q for w, q in self.zoo.quantized_for_qp(self.qp).items()
                if w in UNITS_PER_CTB}

    def layer_spans(self):
        """The PNN forward's card time a step: CUDA events around the
        benchmark's own calls of the port's quantized forward on contexts
        of a launch's size (every slot of the batch), as many of each
        width as a step makes."""
        models = self._pnn_models()
        if not models or self.device.type != "cuda":
            return {}
        n = min(self.nby, (self.nbx + 1) // 2 + 1) * self.batch
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        calls = []
        for w, q in sorted(models.items()):
            params = self.pnn_q.params_from_numpy(q, self.device)
            above = (torch.randint(0, 256, (n, w, 3 * w, 1), generator=gen,
                                   device=self.device).float() - 128.0)
            left = (torch.randint(0, 256, (n, 2 * w, w, 1), generator=gen,
                                  device=self.device).float() - 128.0)
            fc = str(np.asarray(q["kind"])) == "fc"
            inp = (torch.cat([above.reshape(n, -1), left.reshape(n, -1)], 1)
                   if fc else (above, left))
            calls += [(params, inp, w, fc)] * UNITS_PER_CTB[w]
        mean = self.config["mean_training"]

        def step():
            for params, inp, w, fc in calls:
                self.pnn_q.predict_pixels_q(params, inp, w, fc, mean)

        step()
        torch.cuda.synchronize(self.device)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(PNN_STEP_REPS):
            step()
        ev1.record()
        torch.cuda.synchronize(self.device)
        return {"pnn_forward_s_per_step":
                ev0.elapsed_time(ev1) * 1e-3 / PNN_STEP_REPS}

    def least_s(self, rates):
        """Least card seconds of one call's useful work (the units of the
        frame's CTBs, launch by launch: each launch carries the valid slots
        of its step): the unit trials, the integer mergers, and the
        whole encode (trials, and every contraction of the PNN forwards)."""
        n_modes = 36 if self.policy == "switch" else 35
        models = self._pnn_models()
        trial = merger = other = 0.0
        for v in self.valid:
            units = int(v) * self.batch
            for n, per_ctb in UNITS_PER_CTB.items():
                trial += per_ctb * roofline.trial_least_s(
                    n, units, n_modes, rates, rate_rows=True,
                    nn_pred=n in models)[0]
                if n in models:
                    m_s, o_s = _pnn_least_s(models[n], n, units, rates)
                    merger += per_ctb * m_s
                    other += per_ctb * o_s
        out = {"trial": trial, "all": trial + merger + other}
        if models:
            out["merger_int"] = merger
        return out

    def release(self):
        # The port keeps its plans' device tensors in a module cache; they
        # are freed before the reference runs.
        getattr(self.w2, "_PLAN_CACHE", {}).clear()
        self.zoo = None


def _pnn_least_s(q, w, n, rates):
    """(integer merger, every other contraction) least seconds of one
    quantized conv-PNN forward over n contexts of width w, from the
    model's shapes: the two branches' convolutions (TF SAME), the merger,
    the transpose convolutions (their useful products only)."""
    strides = [int(s) for s in np.asarray(q["strides"])]
    other = 0.0
    for branch, (hh, ww) in (("branch_above", (w, 3 * w)),
                             ("branch_left", (2 * w, w))):
        for i, s in enumerate(strides):
            k, _, cin, cout = q[f"{branch}/w_{i}"].shape
            ho, wo = -(-hh // s), -(-ww // s)
            other += roofline.contraction_least_s(
                n * ho * wo, k * k * cin, cout, n * hh * ww * cin * 2,
                k * k * cin * cout * 2, n * ho * wo * cout * 4, rates)
            hh, ww = ho, wo
    m, p, o = q["merger/w"].shape
    merger = roofline.merger_int_least_s(n, p, o, m, rates)[0]
    side = w // int(np.prod(strides))
    hh = ww = side
    for i, s in enumerate(strides[::-1]):
        k, _, cout, cin_w = q[f"merger/t_w_{i}"].shape
        other += roofline.contraction_least_s(
            n * hh * ww, k * k * cin_w, cout, n * hh * ww * cin_w * 2,
            k * k * cin_w * cout * 2, n * hh * s * ww * s * cout * 4, rates)
        hh, ww = hh * s, ww * s
    return merger, other


def compare(config, traffic, pairs, device):
    """Holds (input frame, the port's outputs) pairs against the plain
    reference's encodes of the same frames: reconstruction pixels and
    streams that differ (limit 0: the codec is exact)."""
    from benchmark.reference import wavefront2 as ref

    frames = np.stack([f for f, _ in pairs])
    refs = ref.encode_frames(frames, config, device)
    return cmp.exact_checks([out for _, out in pairs], refs)
