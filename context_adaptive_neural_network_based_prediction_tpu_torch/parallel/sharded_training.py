"""PNN training over a data x model mesh of ranks: data and tensor
parallelism.

The port of the JAX package's `parallel/sharded_training.py`
(`shard_params` :27, `make_sharded_train_step` :76, `make_sharded_train_chunk`
:123, `train_sharded` :185, `run_sharded_demo_step` :236).  The JAX package
annotates shardings and lets XLA place the collectives; here every rank
of a `mesh.make_mesh({"data": dp, "model": tp})` runs the step on its
shard and the collectives are written out:

* **Data parallelism over "data".**  Every rank draws the global batch's
  masks from the same `torch.Generator` (as the single-device step draws
  them) and takes its slice of the batch; the gradients are summed over
  "data" (one all-reduce of all leaves) and divided by dp, so the update
  is the global batch's mean gradient.
* **Tensor parallelism over "model"**, with the JAX package's specs leaf by
  leaf (`param_specs`; a dim that does not divide is replicated):
  the FC layers 0-2 are column-parallel, their input all-gathered before
  layers 1 and 2, and layer 3 is row-parallel, summed over "model" after
  it; the convolutions shard their output maps, with the input maps
  all-gathered where a layer needs all of them; the channelwise merger
  shards its maps, which the branches' outputs already are; the
  transpose convolutions shard their input maps, their partial sums
  summed and split over "model" (all-reduce then slice: Gloo has no
  reduce-scatter).  Each collective is an autograd function whose
  backward is the matching collective.
* Adam runs on the shards (`training.adam_update`, elementwise).  A
  checkpoint is gathered to the JAX layout and written by rank 0
  (`training.save_checkpoint`), so a sharded run resumes on one device
  and the other way round.

The step differentiates the plain versions of the FC and merger kernels,
as `training.train_step` does (their wrappers refuse tensors that require
grad): no kernel runs here.  Under `training.exact_steps` (TF32 and cuDNN
off) the DP x TP step equals the single-device step up to the order of
its sums.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..models import pnn, training, zoo
from ..ops import merger as merger_ops
from . import mesh as mesh_mod

DATA, MODEL = "data", "model"


# -------------------------------------------------------------- shardings --

def _spec(path, shape, tp: int, is_fully_connected: bool):
    """The JAX package's partition spec of one leaf (its layout), before
    the divisibility rule (:32-60)."""
    name, ndim = path[-1], len(shape)
    if is_fully_connected:
        if name.startswith("weights"):
            return (MODEL, None) if int(name.split("_")[1]) == 3 \
                else (None, MODEL)
        if name.startswith("biases"):
            return (None,) if int(name.split("_")[1]) == 3 else (MODEL,)
    else:
        if ndim == 4:
            return (None, None, None, MODEL)
        if ndim == 3:
            return (MODEL, None, None)
        if ndim == 2:
            return (MODEL, None)
        if ndim == 1:
            return (MODEL,) if shape[0] % tp == 0 else (None,)
    return (None,)


def param_specs(params: dict, tp: int, is_fully_connected: bool) -> dict:
    """The partition spec of every leaf of `params` (JAX layout, numpy)
    over a "model" dim of size `tp`, as the JAX package's `shard_params`
    assigns them: a spec whose named dim does not divide by `tp` becomes
    all None (replicated)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        shape = np.shape(node)
        spec = _spec(path, shape, tp, is_fully_connected)
        if any(a is not None and d % tp for a, d in zip(spec, shape)):
            spec = (None,) * len(shape)
        return spec

    return walk(params, ())


def param_shardings(params: dict, mesh, is_fully_connected: bool) -> dict:
    """`param_specs` over `mesh`'s "model" dim as `NamedSharding`s."""
    tp = mesh_mod.axis_size(mesh, MODEL)
    return training.tree_map(
        lambda spec: mesh_mod.named_sharding(mesh, *spec),
        param_specs(params, tp, is_fully_connected))


def shard_params(params: dict, mesh, is_fully_connected: bool,
                 device="cuda") -> dict:
    """This rank's shard of every leaf of `params` (the JAX layout, numpy),
    as tensors on `device` in the port's layouts (`zoo.params_from_numpy`):
    float32, or float64 where the leaves are float64."""
    return _shard_tree(params, param_shardings(params, mesh,
                                               is_fully_connected), device)


def _shard_tree(tree, shardings, device):
    """The shards of a tree of numpy leaves, in the leaves' dtype (float64
    leaves give a float64 run, the reference of a float32 one)."""
    wide = False

    def walk(node, sh):
        nonlocal wide
        if isinstance(node, dict):
            return {k: walk(v, sh[k]) for k, v in node.items()}
        node = np.asarray(node)
        wide = wide or node.dtype == np.float64
        return sh.local(node)

    local = walk(tree, shardings)
    return zoo.params_from_numpy(
        local, device, dtype=torch.float64 if wide else torch.float32)


def gather_tree(local: dict, shardings: dict) -> dict:
    """The full leaves (JAX layout, numpy in the shards' float dtype) of a
    tree of shards in the port's layouts: each sharded leaf all-gathered
    over its mesh dim.  Every rank calls it."""
    host = zoo.params_to_numpy(local)
    dev = training._params_device(local)

    def walk(node, sh):
        if isinstance(node, dict):
            return {k: walk(v, sh[k]) for k, v in node.items()}
        for dim, axis in enumerate(sh.spec):
            if axis is not None:
                group = sh.mesh.get_group(axis)
                parts = mesh_mod.all_gather(torch.from_numpy(node).to(dev),
                                            group)
                node = np.concatenate([p.cpu().numpy() for p in parts],
                                      axis=dim)
        return node

    return walk(host, shardings)


# ------------------------------------------------------------ collectives --

def _world(group):
    return dist.get_world_size(group)


def _chunk(x, dim, group):
    i, _ = mesh_mod.group_position(group)
    return x.chunk(_world(group), dim)[i].contiguous()


class _Copy(torch.autograd.Function):
    """Identity forward; the gradient summed over the group (a replicated
    input of a layer whose ranks compute different outputs)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return mesh_mod.all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """Sum over the group forward (partial sums); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return mesh_mod.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    """This rank's chunk of a replicated tensor along `dim`; backward
    all-gathers the chunks' gradients."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(mesh_mod.all_gather(g, ctx.group), ctx.dim), \
            None, None


class _Gather(torch.autograd.Function):
    """Every rank's chunk concatenated along `dim`; backward keeps this
    rank's chunk of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(mesh_mod.all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    """Partial sums summed over the group, this rank's chunk along `dim`
    (an all-reduce, then a slice); backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(mesh_mod.all_reduce(x, group), dim, group)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(mesh_mod.all_gather(g, ctx.group), ctx.dim), \
            None, None


class _Model:
    """The "model" dim's collectives on activations kept either whole
    (replicated, `full`) or split along their feature dim."""

    def __init__(self, group):
        self.group = group
        self.one = _world(group) == 1

    def copy(self, x):
        return x if self.one or not x.requires_grad \
            else _Copy.apply(x, self.group)

    def reduce(self, x):
        return x if self.one else _Reduce.apply(x, self.group)

    def split(self, x, dim):
        return x if self.one else _Split.apply(x, dim, self.group)

    def gather(self, x, dim):
        return x if self.one else _Gather.apply(x, dim, self.group)

    def reduce_scatter(self, x, dim):
        return x if self.one else _ReduceScatter.apply(x, dim, self.group)

    def whole(self, x, full, dim):
        return x if full else self.gather(x, dim)


def _sharded(spec) -> bool:
    return any(a is not None for a in spec)


# -------------------------------------------------------------- forwards --

def _fc_forward(p, s, x, m: _Model, width_target: int):
    """The FC PNN on sharded layers: (N, 5w^2) -> (N, w, w, 1), whole."""
    full = True
    for i in range(4):
        w, b = p[f"weights_{i}"], p[f"biases_{i}"]
        spec = s[f"weights_{i}"]
        if spec == (None, MODEL):               # column-parallel
            x = m.copy(m.whole(x, full, 1))
            x = torch.matmul(x, w) + b
            full = False
        elif spec == (MODEL, None):             # row-parallel
            if full:
                x = m.split(x, 1)
            x = m.reduce(torch.matmul(x, w)) + b
            full = True
        else:
            x = torch.matmul(m.whole(x, full, 1), w) + b
            full = True
        if i < 3:
            x = pnn.leaky_relu(x)
    x = m.whole(x, full, 1)
    return x.reshape(x.shape[0], width_target, width_target, 1)


def _bias(b, spec, m):
    """A bias whole, gathered where it is sharded."""
    return m.gather(b, 0) if _sharded(spec) else b


def _conv_forward(p, s, above, left, m: _Model, width_target: int):
    """The convolutional PNN on sharded maps: above (N, w, 3w, 1), left
    (N, 2w, w, 1) NHWC -> (N, w, w, 1), whole."""
    strides = pnn.STRIDES_BRANCH[width_target]

    def branch(bp, bs, x):
        full = True
        for i, st in enumerate(strides):
            lw, ls = bp[f"convolution_{i}"], bs[f"convolution_{i}"]
            x = m.whole(x, full, 1)
            if _sharded(ls["weights"]):         # output maps sharded
                x = pnn.conv2d_same(m.copy(x), lw["weights"], st) \
                    + lw["biases"][:, None, None]
                full = False
            else:
                x = pnn.conv2d_same(x, lw["weights"], st) \
                    + _bias(lw["biases"], ls["biases"], m)[:, None, None]
                full = True
            x = pnn.leaky_relu(x)
        return x, full

    nchw = lambda t: t.permute(0, 3, 1, 2)
    x0, f0 = branch(p["branch_above"], s["branch_above"], nchw(above))
    x1, f1 = branch(p["branch_left"], s["branch_left"], nchw(left))
    mp, ms = p["merger"], s["merger"]
    cm, cs = mp["channelwise_fully_connected_merger"], \
        ms["channelwise_fully_connected_merger"]
    if _sharded(cs["weights"]):                 # maps sharded
        x0 = x0 if not f0 else m.split(x0, 1)
        x1 = x1 if not f1 else m.split(x1, 1)
        full = False
    else:
        x0, x1 = m.whole(x0, f0, 1), m.whole(x1, f1, 1)
        full = True
    w_out = width_target // int(np.prod(strides))
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    # The merger's biases (O, M) split by map with its weights.
    x = pnn.channelwise_fc_merger(cm["weights"], cm["biases"], nhwc(x0),
                                  nhwc(x1), w_out, w_out, act=True,
                                  merger_op=merger_ops.merger_plain)
    x = x.permute(0, 3, 1, 2)
    strides_merger = strides[::-1]
    for i, st in enumerate(strides_merger):
        lw = mp[f"transpose_convolution_{i}"]
        ls = ms[f"transpose_convolution_{i}"]
        if _sharded(ls["weights"]):             # input maps sharded
            if full:
                x = m.split(x, 1)
            part = pnn.conv2d_transpose_same(x, lw["weights"], st)
            if _sharded(ls["biases"]):
                x = m.reduce_scatter(part, 1) + lw["biases"][:, None, None]
                full = False
            else:
                x = m.reduce(part) + lw["biases"][:, None, None]
                full = True
        else:
            x = pnn.conv2d_transpose_same(m.whole(x, full, 1), lw["weights"],
                                          st) \
                + _bias(lw["biases"], ls["biases"], m)[:, None, None]
            full = True
        if i != len(strides_merger) - 1:
            x = pnn.leaky_relu(x)
    return nhwc(m.whole(x, full, 1))


def _weight_l2(params, specs, m: _Model):
    """The decay's sum of squares over the whole model: the sharded
    leaves' sums added over "model", the replicated leaves' once."""
    sharded, replicated = 0.0, 0.0

    def walk(node, spec, name=""):
        nonlocal sharded, replicated
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], spec[k], k)
        elif name.startswith("weights"):
            term = 0.5 * torch.sum(node ** 2)
            if _sharded(spec):
                sharded = sharded + term
            else:
                replicated = replicated + term

    walk(params, specs)
    if torch.is_tensor(sharded):
        sharded = m.reduce(sharded)
    return sharded + replicated


# ------------------------------------------------------------------ step --

class ShardedModel:
    """The mesh, the model's specs and its dims' groups for one net:
    what a sharded step needs besides its state."""

    def __init__(self, mesh, width_target: int, is_fully_connected: bool):
        self.mesh = mesh
        self.width_target = width_target
        self.is_fully_connected = is_fully_connected
        template = pnn.init_params(torch.Generator().manual_seed(0),
                                   width_target, is_fully_connected)
        self.dp = mesh_mod.axis_size(mesh, DATA)
        self.tp = mesh_mod.axis_size(mesh, MODEL)
        self.specs = param_specs(template, self.tp, is_fully_connected)
        self.shardings = param_shardings(template, mesh, is_fully_connected)
        self.data_group = mesh.get_group(DATA)
        self.model = _Model(mesh.get_group(MODEL))
        self.data_index = mesh.get_local_rank(DATA)

    def forward(self, params, inputs):
        if self.is_fully_connected:
            return _fc_forward(params["fully_connected"],
                               self.specs["fully_connected"], inputs,
                               self.model, self.width_target)
        above, left = inputs
        return _conv_forward(params["convolutional"],
                             self.specs["convolutional"], above, left,
                             self.model, self.width_target)

    def weight_l2(self, params):
        return _weight_l2(params, self.specs, self.model)

    def batch_slice(self, n: int) -> slice:
        if n % self.dp:
            raise ValueError(f"batch {n} does not split over dp = {self.dp}")
        k = n // self.dp
        return slice(self.data_index * k, (self.data_index + 1) * k)

    def data_mean(self, grads: dict) -> dict:
        """Every gradient leaf summed over "data" (one all-reduce of all
        leaves), divided by dp."""
        if self.dp == 1:
            return grads
        paths = list(training._paths(grads))
        leaves = [training._get(grads, p) for p in paths]
        flat = mesh_mod.all_reduce(torch.cat([g.reshape(-1) for g in leaves]),
                                   self.data_group) / self.dp
        out, pos = {}, 0
        for path, g in zip(paths, leaves):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = flat[pos:pos + g.numel()].view_as(g)
            pos += g.numel()
        return out

    def init_state(self, generator: torch.Generator, device="cuda"):
        """A new net drawn from `generator` (as `training.init_state`
        draws it; every rank the same draws), sharded, zero moments."""
        full = pnn.init_params(generator, self.width_target,
                               self.is_fully_connected)
        params = _shard_tree(full, self.shardings, device)
        zeros = lambda: training.tree_map(torch.zeros_like, params)
        return training.TrainState(
            params, (training.AdamState(0, zeros(), zeros()),
                     training.ScheduleState(0)), 0)

    def state_from_numpy(self, blob: dict, device="cuda"):
        """A checkpoint's content (`training.read_checkpoint`) sharded."""
        adam, sched = blob["opt_state"]
        put = lambda tree: _shard_tree(tree, self.shardings, device)
        return training.TrainState(
            put(blob["params"]),
            (training.AdamState(int(adam.count), put(adam.mu),
                                put(adam.nu)),
             training.ScheduleState(int(sched.count))), int(blob["step"]))

    def gather_state(self, state) -> dict:
        """The whole state (JAX layout, numpy; `training.state_to_numpy`'s
        form) gathered from the shards.  Every rank calls it."""
        adam, sched = state.opt_state
        g = lambda tree: gather_tree(tree, self.shardings)
        return {"params": g(state.params),
                "opt_state": (training.AdamState(
                    np.asarray(adam.count, np.int32), g(adam.mu),
                    g(adam.nu)),
                    training.ScheduleState(np.asarray(sched.count,
                                                      np.int32))),
                "step": int(state.step)}


def sharded_train_step(model: ShardedModel, state, generator,
                       portions_above_uint8, portions_left_uint8,
                       targets_uint8, mean_training: float, masks, *,
                       coeff_l2: float, coeff_grad: float,
                       random_masks: bool,
                       total_iters: int = training.NB_ITERS_TRAINING):
    """One DP x TP update on a global uint8 batch (every rank passes the
    same batch and generator state): `training.train_step` with this
    rank's slice of the batch and its shards.  Returns (new state, the
    global batch's loss, this rank's terms)."""
    n = targets_uint8.shape[0]
    w = model.width_target
    if random_masks:
        wa, hl = training.draw_masks(generator, n, w)
    else:
        wa = torch.full((n,), int(masks[0]))
        hl = torch.full((n,), int(masks[1]))
    sl = model.batch_slice(n)
    with training.exact_steps():
        loss, terms, grads = training.loss_and_grads(
            state.params, portions_above_uint8[sl], portions_left_uint8[sl],
            targets_uint8[sl], mean_training, wa[sl], hl[sl],
            width_target=w, is_fully_connected=model.is_fully_connected,
            coeff_l2=coeff_l2, coeff_grad=coeff_grad, forward=model.forward,
            weight_l2=model.weight_l2)
        grads = model.data_mean(grads)
        opt_state = training.adam_update(state.params, grads,
                                         state.opt_state, w, total_iters)
    if model.dp > 1:
        loss = mesh_mod.all_reduce(loss, model.data_group) / model.dp
    return (training.TrainState(state.params, opt_state, state.step + 1),
            loss, terms)


def make_sharded_train_step(mesh, width_target: int,
                            is_fully_connected: bool,
                            mean_training: float = 117.895,
                            coeff_l2: float = 1.0, coeff_grad: float = 0.0,
                            device="cuda"):
    """(init_fn, step_fn): `init_fn(generator)` -> sharded TrainState;
    `step_fn(state, generator, above, left, targets)` -> (state, loss),
    random masks, the global batch on every rank."""
    model = ShardedModel(mesh, width_target, is_fully_connected)

    def step_fn(state, generator, above_u8, left_u8, targets_u8):
        state, loss, _ = sharded_train_step(
            model, state, generator, above_u8, left_u8, targets_u8,
            mean_training, (0, 0), coeff_l2=coeff_l2, coeff_grad=coeff_grad,
            random_masks=True)
        return state, loss

    return lambda generator: model.init_state(generator, device), step_fn


def make_sharded_train_chunk(mesh, width_target: int,
                             is_fully_connected: bool,
                             mean_training: float = 117.895,
                             coeff_l2: float = 1.0, coeff_grad: float = 0.0,
                             total_iters: int | None = None, device="cuda"):
    """(init_fn, chunk_fn): `chunk_fn(state, generator, above, left,
    targets)` runs K updates over (K, B, ...) uint8 stacks, random masks,
    and returns (state, per-step losses (K,)): the DP x TP twin of
    `training.train_chunk`, which `cli/train_pnn --dp/--tp` drives."""
    model = ShardedModel(mesh, width_target, is_fully_connected)
    return (lambda generator: model.init_state(generator, device),
            _chunk_fn(model, mean_training, coeff_l2, coeff_grad,
                      training.NB_ITERS_TRAINING if total_iters is None
                      else total_iters))


def _chunk_fn(model, mean_training, coeff_l2, coeff_grad, iters):
    def chunk_fn(state, generator, above_u8, left_u8, targets_u8):
        dev = training._params_device(state.params)
        stacked = [training._as_tensor(a, dev)
                   for a in (above_u8, left_u8, targets_u8)]
        out = []
        for a, l, t in zip(*stacked):
            state, loss, _ = sharded_train_step(
                model, state, generator, a, l, t, mean_training, (0, 0),
                coeff_l2=coeff_l2, coeff_grad=coeff_grad, random_masks=True,
                total_iters=iters)
            out.append(loss)
        return state, torch.stack(out)

    return chunk_fn


def train_sharded(mesh, shards_dir: str, width_target: int,
                  is_fully_connected: bool, mean_training: float,
                  out_dir: str, *, iters: int, batch_size: int = 100,
                  chunk: int = 50, snapshot_every: int = 10_000,
                  coeff_l2: float = 1.0, coeff_grad: float = 0.0,
                  log=print, device="cuda"):
    """Drives `make_sharded_train_chunk` to `iters` steps with snapshots
    (`training.run_training`, the single-device run's loop): every rank
    reads the same global batches from the shard pipeline, the state stays
    sharded, and a snapshot gathers it to rank 0, which writes
    `model_<step>.ckpt.pkl` with the mask generator's state.  A run
    resumes from the newest snapshot in `out_dir` (either package's, or a
    single-device run's).  The net and the masks are seeded as a
    single-device run's.  Rank 0 logs."""
    model = ShardedModel(mesh, width_target, is_fully_connected)
    rank0 = dist.get_rank() == 0

    def save(state, mask_gen):
        blob = model.gather_state(state)
        path = training.save_checkpoint(
            training.state_from_numpy(blob, "cpu"), out_dir, mask_gen) \
            if rank0 else None
        dist.barrier()
        return path

    return training.run_training(
        out_dir, shards_dir, width_target, iters=iters,
        batch_size=batch_size, chunk=chunk, snapshot_every=snapshot_every,
        init_state=lambda gen: model.init_state(gen, device),
        state_from_blob=lambda blob: model.state_from_numpy(blob, device),
        chunk_fn=_chunk_fn(model, mean_training, coeff_l2, coeff_grad,
                           iters),
        save=save, log=log if rank0 else (lambda msg: None))


def run_sharded_demo_step(mesh, width_target: int = 8,
                          is_fully_connected: bool = True,
                          batch_size: int = 16, seed: int = 0,
                          n_steps: int = 2, device="cuda") -> float:
    """A few production sharded chunk updates on seeded synthetic data
    (the dry run's): returns the last loss."""
    rng = np.random.default_rng(seed)
    w = width_target
    above = rng.integers(0, 256, (n_steps, batch_size, w, 3 * w, 1),
                         dtype=np.uint8)
    left = rng.integers(0, 256, (n_steps, batch_size, 2 * w, w, 1),
                        dtype=np.uint8)
    targets = rng.integers(0, 256, (n_steps, batch_size, w, w, 1),
                           dtype=np.uint8)
    init_fn, chunk_fn = make_sharded_train_chunk(mesh, w, is_fully_connected,
                                                 device=device)
    state = init_fn(torch.Generator().manual_seed(seed))
    state, losses_k = chunk_fn(state, torch.Generator().manual_seed(seed + 1),
                               above, left, targets)
    if int(state.step) != n_steps:
        raise AssertionError(f"{state.step} steps, want {n_steps}")
    return float(losses_k[-1])


def chunk_from_state(axis_sizes: dict, width_target: int,
                     is_fully_connected: bool, blob: dict, generator_state,
                     above_u8, left_u8, targets_u8, mean_training: float,
                     *, masks=None, coeff_l2: float = 1.0,
                     coeff_grad: float = 0.0,
                     total_iters: int = training.NB_ITERS_TRAINING,
                     float64: bool = False, device="cuda"):
    """K sharded updates over (K, B, ...) stacks from a whole state `blob`
    (`training.state_to_numpy`'s form) and a mask generator's state, on a
    mesh of `axis_sizes` over the group: random masks, or `masks` for
    every example; in float64 where `float64` is set (the blob widened).
    Returns (losses (K,) numpy, the whole state after them, gathered).
    The rank function of `mesh.spawn_ranks` for holding the sharded chunk
    against the single-device one."""
    mesh = mesh_mod.make_mesh(axis_sizes)
    model = ShardedModel(mesh, width_target, is_fully_connected)
    if float64:
        wide = lambda tree: training.tree_map(
            lambda a: np.asarray(a, np.float64), tree)
        adam, sched = blob["opt_state"]
        blob = dict(blob, params=wide(blob["params"]), opt_state=(
            training.AdamState(adam.count, wide(adam.mu), wide(adam.nu)),
            sched))
    state = model.state_from_numpy(blob, device)
    gen = torch.Generator()
    gen.set_state(torch.as_tensor(generator_state))
    out = []
    for a, l, t in zip(above_u8, left_u8, targets_u8):
        state, loss, _ = sharded_train_step(
            model, state, gen, a, l, t, mean_training,
            (0, 0) if masks is None else masks, coeff_l2=coeff_l2,
            coeff_grad=coeff_grad, random_masks=masks is None,
            total_iters=total_iters)
        out.append(float(loss))
    return np.array(out, np.float32), model.gather_state(state)
