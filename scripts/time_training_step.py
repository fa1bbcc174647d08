"""Precision and time of one PNN training step on the card, with PyTorch's
own CUDA convolutions (what `training.exact_steps` runs) and with cuDNN's.

For the conv PNN at widths 16 and 64 (batch 100, seeded uint8 batch and
masks, `training.init_state` from seed 0, the l2 loss with and without
the gradient error): the first step's gradients (`training.loss_and_grads`)
on the card in float32, TF32 off, under each convolution route, held
against the same step on the CPU in float64: the loss's relative error
and, per leaf, the largest error relative to the leaf's max |g| (the
worst leaf is printed).  Then seconds a step under each route
(`loss_and_grads` and `adam_update`, as `train_step` runs them; CUDA
events around `--steps` steps after one warm-up step).  Routes: `native`
(cuDNN off, as `exact_steps` sets it) and `cudnn` (cuDNN on,
deterministic, TF32 off).  One JSON line per width,
loss and route, then the card's name and power limit.

Usage (on the card):  python scripts/time_training_step.py [--steps 10]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from context_adaptive_neural_network_based_prediction_tpu_torch.models import (  # noqa: E402
    pnn, training)

MEAN = 86.8568
BATCH = 100


@contextlib.contextmanager
def route(name):
    """The convolution route of a step: `native` is `exact_steps`;
    `cudnn` keeps cuDNN on (deterministic), TF32 off."""
    if name == "native":
        with training.exact_steps():
            yield
        return
    flags = (torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.enabled = True
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with pnn.full_f32():
            yield
    finally:
        (torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this measurement needs the card")
    dev = torch.device("cuda", 0)
    for w in (16, 64):
        rng = np.random.default_rng(1)
        batch = (rng.integers(0, 256, (BATCH, w, 3 * w, 1), dtype=np.uint8),
                 rng.integers(0, 256, (BATCH, 2 * w, w, 1), dtype=np.uint8),
                 rng.integers(0, 256, (BATCH, w, w, 1), dtype=np.uint8))
        wa, hl = training.draw_masks(torch.Generator().manual_seed(1), BATCH,
                                     w)
        init = lambda d: training.init_state(torch.Generator().manual_seed(0),
                                             w, False, device=d)
        for coeff_grad in (0.0, 0.5):
            kw = dict(width_target=w, is_fully_connected=False, coeff_l2=1.0,
                      coeff_grad=coeff_grad)
            with training.exact_steps():
                l_ref, _, g_ref = training.loss_and_grads(
                    training.tree_map(torch.Tensor.double,
                                      init("cpu").params),
                    *batch, MEAN, wa, hl, **kw)
            for name in ("native", "cudnn"):
                with route(name):
                    loss, _, g = training.loss_and_grads(
                        init(dev).params, *batch, MEAN, wa, hl, **kw)
                g = dict(leaves(g))
                errs = {k: float(((g[k].cpu().double() - v).abs()
                                  / v.abs().max()).max())
                        for k, v in leaves(g_ref)}
                worst = max(errs, key=errs.get)
                state = init(dev)

                def step(s):
                    # `train_step` without its own flags: the route's.
                    _, _, grads = training.loss_and_grads(
                        s.params, *batch, MEAN, wa, hl, **kw)
                    return s._replace(opt_state=training.adam_update(
                        s.params, grads, s.opt_state, w), step=s.step + 1)

                with route(name):
                    state = step(state)                 # warm-up
                    torch.cuda.synchronize()
                    t0, t1 = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                    t0.record()
                    for _ in range(args.steps):
                        state = step(state)
                    t1.record()
                    torch.cuda.synchronize()
                print(json.dumps({
                    "width": w, "coeff_grad": coeff_grad, "route": name,
                    "loss_rel_err": abs(float(loss) - float(l_ref))
                    / abs(float(l_ref)),
                    "worst_leaf": worst, "worst_leaf_err": errs[worst],
                    "s_per_step": t0.elapsed_time(t1) / 1e3 / args.steps}),
                    flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
