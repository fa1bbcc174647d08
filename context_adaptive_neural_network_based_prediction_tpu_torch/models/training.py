"""PNN training: Adam with the step-keyed schedule, the train step,
checkpoint and resume.

The port of the JAX package's `models/training.py`
(`learning_rate_schedule` :44, `make_optimizer` :62, `init_state` :67,
`_train_step_impl` :74-122, `train_chunk` :127-158, `save_checkpoint`
:163, `restore_checkpoint` :176, `find_latest_checkpoint` :183).  The
recipe is the reference's:

* Adam (b1 0.9, b2 0.999, eps 1e-8) in optax's order: the moments, the
  bias corrections, mu_hat / (sqrt(nu_hat) + eps), times -lr, added to
  the params, each step in float32 as optax computes it;
* a piecewise-constant learning rate, 1e-4 for widths <= 8 and 4e-4 for
  wider, times 0.1 at total_iters // 2, 3 total_iters // 4 and
  7 total_iters // 8, keyed to the optimizer's count before the update
  (scaled once count >= boundary), so it survives a resume;
* loss = coeff_l2 x the l2-norm error + coeff_grad x the gradient error
  + weight decay (`models/losses.py`);
* masks fixed, or drawn per example from {0, 4, ..., w}.

The step takes raw uint8 batches; the mean subtraction, masking, forward
(`pnn.forward_train`: the plain versions of the FC and merger kernels,
which have no backward), loss, gradients (autograd) and the update run on
the params' device.  On the card TF32 is off and cuDNN is off for the
duration of a step (`exact_steps`: PyTorch's own CUDA convolutions,
deterministic and float32-accurate), and the caller's flags are back
afterwards, also when the step raises, so a resumed run equals an
uninterrupted one.

Params, gradients and Adam moments live on the device in the port's
layouts (`zoo.params_from_numpy`); the Adam update changes the params in
place.  Checkpoints (`model_<step>.ckpt.pkl`) hold numpy in the JAX
package's layout and structure (`opt_state` = (Adam state, schedule
state) as optax's `adam` chain keeps it), so the JAX package reads the
params, and `restore_checkpoint` reads a checkpoint the JAX package wrote
without importing jax or optax: a restricted unpickler maps optax's
`ScaleByAdamState` / `ScaleByScheduleState` to this module's classes and
refuses every global other than those and numpy's array reconstruction.

Random masks come from a CPU `torch.Generator`, so a seed gives the same
masks on every device; the JAX package draws them from threefry keys
inside its step, which no generator here reproduces.  `save_checkpoint`
can keep the generator's state beside the training state, so that a
resumed run draws the masks an uninterrupted one would.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time
from typing import NamedTuple

import numpy as np
import torch

from ..data.pipeline import TrainingPipeline
from . import losses, pnn, zoo

NB_ITERS_TRAINING = 800_000
B1, B2, EPS = 0.9, 0.999, 1e-8
LR_SCALE = 0.1


class AdamState(NamedTuple):
    """optax's `ScaleByAdamState`: the update count and the moments."""
    count: int
    mu: dict
    nu: dict


class ScheduleState(NamedTuple):
    """optax's `ScaleByScheduleState`: the count the schedule reads."""
    count: int


class TrainState(NamedTuple):
    params: dict                # tensors on the device, port layouts
    opt_state: tuple            # (AdamState, ScheduleState)
    step: int


# ------------------------------------------------------------- schedule ----

def learning_rate_schedule(width_target: int,
                           total_iters: int = NB_ITERS_TRAINING):
    """count -> float32 learning rate: the base times 0.1 at each boundary
    count has reached, as optax's `piecewise_constant_schedule` computes it
    (float32 products, the count before the update)."""
    base = 1.0e-4 if width_target <= 8 else 4.0e-4
    boundaries = (total_iters // 2, 3 * total_iters // 4,
                  7 * total_iters // 8)

    def schedule(count):
        v = np.float32(base)
        for threshold in sorted(boundaries):
            if count >= threshold:
                v = np.float32(np.float32(LR_SCALE) * v)
        return v

    return schedule


# ---------------------------------------------------------------- trees ----

def _paths(tree, prefix=()):
    """Leaf paths of a nested dict, keys in sorted order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_map(fn, tree):
    """`fn` of every leaf of a nested dict, in a dict of the same nesting."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _params_device(params):
    return _get(params, next(_paths(params))).device


# ---------------------------------------------------------------- state ----

def init_state(generator: torch.Generator, width_target: int,
               is_fully_connected: bool, total_iters: int = NB_ITERS_TRAINING,
               device="cuda") -> TrainState:
    """A new net (`pnn.init_params` from `generator`) on `device`, zero
    moments, step 0.  `total_iters` is the schedule's, passed to each
    step (kept for the JAX package's signature)."""
    del total_iters
    params = zoo.params_from_numpy(
        pnn.init_params(generator, width_target, is_fully_connected), device)
    zeros = lambda: tree_map(torch.zeros_like, params)
    return TrainState(params, (AdamState(0, zeros(), zeros()),
                               ScheduleState(0)), 0)


def state_from_numpy(blob: dict, device="cuda") -> TrainState:
    """{"params", "opt_state", "step"} in the JAX layout (numpy; a
    checkpoint's content, the JAX package's `TrainState` fields) -> a
    `TrainState` on `device`."""
    adam, sched = blob["opt_state"]
    put = lambda tree: zoo.params_from_numpy(tree, device)
    return TrainState(put(blob["params"]),
                      (AdamState(int(adam.count), put(adam.mu),
                                 put(adam.nu)),
                       ScheduleState(int(sched.count))),
                      int(blob["step"]))


def cast_state(state: TrainState, dtype) -> TrainState:
    """A copy of `state` with its params and Adam moments in `dtype`
    (float64: a float64 run, the reference of a float32 one)."""
    adam, sched = state.opt_state
    cast = lambda tree: tree_map(lambda t: t.to(dtype, copy=True), tree)
    return TrainState(cast(state.params),
                      (AdamState(adam.count, cast(adam.mu), cast(adam.nu)),
                       sched), state.step)


def state_to_numpy(state: TrainState) -> dict:
    """The inverse of `state_from_numpy`: numpy in the JAX layout, the
    counts as int32 scalars as optax keeps them."""
    adam, sched = state.opt_state
    return {"params": zoo.params_to_numpy(state.params),
            "opt_state": (AdamState(np.asarray(adam.count, np.int32),
                                    zoo.params_to_numpy(adam.mu),
                                    zoo.params_to_numpy(adam.nu)),
                          ScheduleState(np.asarray(sched.count, np.int32))),
            "step": int(state.step)}


# ----------------------------------------------------------------- step ----

@contextlib.contextmanager
def exact_steps():
    """cuBLAS in float32, not TF32, and cuDNN off, for the duration of the
    block: the card's convolutions then run PyTorch's own CUDA kernels
    (im2col and float32 products), which are deterministic and whose
    gradients stay within float32 rounding of float64 (cuDNN's
    deterministic float32 backward algorithms were a few 1e-2 of a leaf's
    max |g| off on an H100: `scripts/time_training_step.py`).  The caller's flags are back
    afterwards, also when the block raises."""
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        with pnn.full_f32():
            yield
    finally:
        torch.backends.cudnn.enabled = enabled


def draw_masks(generator: torch.Generator, n: int, width_target: int):
    """Per-example (width_mask_above, height_mask_left), each uniform on
    {0, 4, ..., w}: two int64 CPU tensors of shape (n,)."""
    hi = width_target // 4 + 1
    wa = 4 * torch.randint(0, hi, (n,), generator=generator)
    hl = 4 * torch.randint(0, hi, (n,), generator=generator)
    return wa, hl


def adam_update(params: dict, grads: dict, opt_state: tuple,
                width_target: int, total_iters: int = NB_ITERS_TRAINING):
    """One Adam update of `params` in place (optax's `adam` with the
    schedule, float32, its order of operations); the moments are updated
    in place too.  Returns the new opt_state."""
    adam, sched = opt_state
    count = adam.count + 1
    lr = learning_rate_schedule(width_target, total_iters)(sched.count)
    f32 = np.float32
    c1, c2 = float(f32(1 - B1)), float(f32(1 - B2))
    bc1 = float(f32(1) - f32(B1) ** f32(count))
    bc2 = float(f32(1) - f32(B2) ** f32(count))
    neg_lr = float(-lr)
    # The bias corrections divide as tensors: PyTorch turns a division by a
    # scalar into a product with its reciprocal, which optax does not.  The
    # square root is taken in float64 and rounded once, correctly rounded
    # as XLA's (PyTorch's float32 one on the CPU is 1 ulp off at times).
    bc = torch.tensor([bc1, bc2], dtype=torch.float32,
                      device=_params_device(params))
    with torch.no_grad():
        for path in _paths(params):
            p, g = _get(params, path), _get(grads, path)
            mu, nu = _get(adam.mu, path), _get(adam.nu, path)
            mu.mul_(float(f32(B1))).add_(g * c1)
            nu.mul_(float(f32(B2))).add_((g * g) * c2)
            root = torch.sqrt((nu / bc[1].expand_as(nu)).double()).float()
            u = (mu / bc[0].expand_as(mu)) / (root + float(f32(EPS)))
            p.add_(u * neg_lr)
    return (AdamState(count, adam.mu, adam.nu), ScheduleState(sched.count + 1))


def _as_tensor(a, dev):
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def loss_and_grads(params: dict, portions_above_uint8, portions_left_uint8,
                   targets_uint8, mean_training: float, wa, hl, *,
                   width_target: int, is_fully_connected: bool,
                   coeff_l2: float, coeff_grad: float, forward=None,
                   weight_l2=losses.weight_l2_norm):
    """The loss, its terms and the gradients (a dict like `params`) on one
    uint8 batch with per-example masks `wa`, `hl` ((N,) tensors), in the
    params' dtype: float32, or float64 for a reference of a float32
    step (float32 gradients of sums over many positions can cancel).
    `forward(params, inputs)` and `weight_l2(params)` replace the
    single-device forward and decay (sharded training's)."""
    leaf = _get(params, next(_paths(params)))
    dev, dtype = leaf.device, leaf.dtype
    w = width_target
    n = targets_uint8.shape[0]
    mean = float(np.float32(mean_training))
    above = _as_tensor(portions_above_uint8, dev).to(dtype) - mean
    left = _as_tensor(portions_left_uint8, dev).to(dtype) - mean
    targets = _as_tensor(targets_uint8, dev).to(dtype) - mean
    wa = wa.to(dev).reshape(-1, 1, 1, 1)
    hl = hl.to(dev).reshape(-1, 1, 1, 1)
    cols = torch.arange(3 * w, device=dev).reshape(1, 1, -1, 1)
    rows = torch.arange(2 * w, device=dev).reshape(1, -1, 1, 1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    above = torch.where(cols >= 3 * w - wa, zero, above)
    left = torch.where(rows >= 2 * w - hl, zero, left)
    if is_fully_connected:
        inputs = torch.cat([above.reshape(n, -1), left.reshape(n, -1)], 1)
    else:
        inputs = (above, left)
    paths = list(_paths(params))
    leaves = [_get(params, p).detach().requires_grad_(True) for p in paths]
    tparams: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tparams
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    with torch.enable_grad():
        preds = (forward(tparams, inputs) if forward is not None else
                 pnn.forward_train(tparams, inputs, w, is_fully_connected))
        loss, terms = losses.total_loss(tparams, targets, preds, coeff_l2,
                                        coeff_grad, weight_l2)
        gl = torch.autograd.grad(loss, leaves)
    grads: dict = {}
    for path, g in zip(paths, gl):
        node = grads
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    return (loss.detach(), {k: v.detach() for k, v in terms.items()},
            grads)


def train_step(state: TrainState, generator, portions_above_uint8,
               portions_left_uint8, targets_uint8, mean_training: float,
               masks, *, width_target: int, is_fully_connected: bool,
               coeff_l2: float, coeff_grad: float, random_masks: bool,
               total_iters: int = NB_ITERS_TRAINING, example_masks=None):
    """One training update on a raw uint8 batch (above (N, w, 3w, 1), left
    (N, 2w, w, 1), targets (N, w, w, 1); numpy or tensors).  Returns
    (new state, loss, terms); the params and moments are updated in
    place.

    `masks` (width_mask_above, height_mask_left) applies to every example
    when `random_masks` is False; otherwise per-example masks are drawn
    from `generator` (`draw_masks`).  `example_masks` = (wa, hl), two (N,)
    integer arrays, gives the per-example masks instead (the masks a JAX
    step drew, for holding the two packages against each other)."""
    n = targets_uint8.shape[0]
    if example_masks is not None:
        wa, hl = (torch.tensor(np.asarray(m)) for m in example_masks)
    elif random_masks:
        wa, hl = draw_masks(generator, n, width_target)
    else:
        wa = torch.full((n,), int(masks[0]))
        hl = torch.full((n,), int(masks[1]))
    with exact_steps():
        loss, terms, grads = loss_and_grads(
            state.params, portions_above_uint8, portions_left_uint8,
            targets_uint8, mean_training, wa, hl, width_target=width_target,
            is_fully_connected=is_fully_connected, coeff_l2=coeff_l2,
            coeff_grad=coeff_grad)
        opt_state = adam_update(state.params, grads, state.opt_state,
                                width_target, total_iters)
    return TrainState(state.params, opt_state, state.step + 1), loss, terms


def train_chunk(state: TrainState, generator, portions_above_uint8,
                portions_left_uint8, targets_uint8, mean_training: float,
                masks, *, width_target: int, is_fully_connected: bool,
                coeff_l2: float, coeff_grad: float, random_masks: bool,
                total_iters: int = NB_ITERS_TRAINING):
    """K updates over stacked batches (K, B, ...) in one call, equal to K
    `train_step`s with the same generator.  The batches are copied to the
    device once.  Returns (state, per-step losses (K,) on the device)."""
    dev = _params_device(state.params)
    stacked = [_as_tensor(a, dev) for a in (
        portions_above_uint8, portions_left_uint8, targets_uint8)]
    out = []
    for a, l, t in zip(*stacked):
        state, loss, _ = train_step(
            state, generator, a, l, t, mean_training, masks,
            width_target=width_target, is_fully_connected=is_fully_connected,
            coeff_l2=coeff_l2, coeff_grad=coeff_grad,
            random_masks=random_masks, total_iters=total_iters)
        out.append(loss)
    return state, torch.stack(out)


# ------------------------------------------------------------ checkpoints ----

def save_checkpoint(state: TrainState, path_to_directory: str,
                    generator: torch.Generator = None) -> str:
    """Writes `model_<step>.ckpt.pkl` holding params + Adam state + step
    (numpy, the JAX layout), and the mask generator's state when one is
    given."""
    os.makedirs(path_to_directory, exist_ok=True)
    blob = state_to_numpy(state)
    if generator is not None:
        blob["mask_generator_state"] = generator.get_state().numpy()
    path = os.path.join(path_to_directory, f"model_{blob['step']}.ckpt.pkl")
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    return path


_RECONSTRUCT = np.empty(0).__reduce__()[0]
_SCALAR = np.float32(0).__reduce__()[0]
_GLOBALS = {
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("optax._src.transform", "ScaleByAdamState"): AdamState,
    ("optax._src.transform", "ScaleByScheduleState"): ScheduleState,
    (__name__, "AdamState"): AdamState,
    (__name__, "ScheduleState"): ScheduleState,
}
for _mod in ("numpy._core.multiarray", "numpy.core.multiarray"):
    _GLOBALS[(_mod, "_reconstruct")] = _RECONSTRUCT
    _GLOBALS[(_mod, "scalar")] = _SCALAR


class _CheckpointUnpickler(pickle.Unpickler):
    """Resolves only the globals a checkpoint of either package names."""

    def find_class(self, module, name):
        try:
            return _GLOBALS[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"checkpoint names {module}.{name}, which is not a "
                f"checkpoint's type") from None


def read_checkpoint(path: str) -> dict:
    """A checkpoint's content (either package's), numpy in the JAX layout,
    read without jax or optax."""
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def restore_checkpoint(path: str, width_target: int, device="cuda",
                       generator: torch.Generator = None) -> TrainState:
    """The `TrainState` of a checkpoint on `device`; `generator` takes the
    mask generator's state where the checkpoint has one."""
    del width_target
    blob = read_checkpoint(path)
    if generator is not None and "mask_generator_state" in blob:
        generator.set_state(torch.from_numpy(blob["mask_generator_state"]))
    return state_from_numpy(blob, device)


def find_latest_checkpoint(path_to_directory: str):
    """Returns (path, step) of the newest snapshot, or (None, 0)."""
    if not os.path.isdir(path_to_directory):
        return None, 0
    best_path, best_step = None, 0
    for name in os.listdir(path_to_directory):
        if name.startswith("model_") and name.endswith(".ckpt.pkl"):
            step = int(name[len("model_"):-len(".ckpt.pkl")])
            if step >= best_step:
                best_path, best_step = (os.path.join(path_to_directory, name),
                                        step)
    return best_path, best_step


# ------------------------------------------------------------------ runs ----

INIT_SEED, MASK_SEED = 0, 1


def run_training(out_dir: str, shards_dir: str, width_target: int, *,
                 iters: int, batch_size: int, chunk: int,
                 snapshot_every: int, init_state, state_from_blob, chunk_fn,
                 save, log=print):
    """Trains to `iters` steps on the shards in `shards_dir` (the shard
    pipeline, on-the-fly extraction for widths >= 16), `chunk` steps a
    call, resuming from the newest snapshot in `out_dir`: the run of
    `cli/train_pnn.py`, on one device or sharded.

    `init_state(generator)` draws a new net from a generator seeded
    `INIT_SEED`; `state_from_blob(blob)` loads a checkpoint's content;
    `chunk_fn(state, mask_generator, above, left, targets)` runs K updates
    over (K, B, ...) uint8 stacks and returns (state, losses (K,));
    `save(state, mask_generator)` writes a snapshot every `snapshot_every`
    steps and at the end and returns its path (None where this process
    writes none).  The masks come from a generator seeded `MASK_SEED`, or
    in the checkpoint's state.  Returns the last state."""
    mask_gen = torch.Generator().manual_seed(MASK_SEED)
    ckpt, start = find_latest_checkpoint(out_dir)
    if ckpt:
        blob = read_checkpoint(ckpt)
        if "mask_generator_state" in blob:
            mask_gen.set_state(torch.from_numpy(
                blob["mask_generator_state"]))
        state = state_from_blob(blob)
        log(f"resumed from {ckpt} (step {start})")
    else:
        state = init_state(torch.Generator().manual_seed(INIT_SEED))
    batches = TrainingPipeline(
        shards_dir, batch_size, width_target,
        is_extraction_on_the_fly=(width_target >= 16)).batches()
    t0 = time.time()
    it = int(state.step)
    while it < iters:
        k = min(chunk, iters - it)
        stacked = [next(batches) for _ in range(k)]
        above, left, target = (np.stack([b[i] for b in stacked])
                               for i in range(3))
        state, losses_k = chunk_fn(state, mask_gen, above, left, target)
        it += k
        log(f"step {it}: loss {float(losses_k[-1]):.3f} "
            f"({(it - int(start)) / (time.time() - t0):.1f} it/s)")
        if it % snapshot_every == 0 or it == iters:
            path = save(state, mask_gen)
            if path is not None:
                log(f"snapshot {path}")
    return state
