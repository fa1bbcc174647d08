"""Named meshes of ranks, shardings, and the ranks' process group.

The port of the JAX package's `parallel/mesh.py` (`make_mesh` :8,
`named_sharding` :25).  The JAX package runs its sharded paths as one SPMD
program over a `jax.sharding.Mesh` of devices; the port runs one process
per rank, as `torchrun` starts them, over `torch.distributed`:

* `make_mesh({"data": 2, "model": 2})` arranges the ranks of the
  initialised default group as a `DeviceMesh` with named dims.  The world
  size must equal the product of the sizes (the JAX package drops spare
  devices; a rank has no spare to drop).
* `named_sharding(mesh, *spec)` is the JAX package's `NamedSharding`: a
  partition spec over the mesh's dim names, which `local` applies to a
  full array (the rank's block of every sharded dim).
* `shift_down`, `all_gather` (`all_gather_arrays` for numpy) and
  `all_reduce` are the collectives of the tiled encoders and of sharded
  training: every rank of a mesh dim sends a tensor to the next one,
  gathers every rank's, or sums them.
* `spawn_ranks(fn, n, ...)` starts n ranks of one group in this machine
  (the `spawn` start method), runs `fn` in each and returns their
  results, for the tests, the dry run and the smoke; `torchrun` does the
  same for a user's command line.  Rank functions here: `run_calls`
  (several of the package's in one group), `check_group` (a probe that
  can fail one rank on purpose) and `loaded_modules` (what a rank
  imported).

Backends.  `rank_placement` picks a rank's backend and card from the
device asked for: Gloo on the CPU, and also where several ranks share one
card (NCCL refuses two ranks on one GPU, so under Gloo a CUDA tensor is
copied to the host for each transfer); NCCL, moving CUDA tensors, where
each rank has its own GPU.  The collectives follow the group's backend,
and a send, receive or collective that fails raises.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import queue as queue_mod
import socket
import sys
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

PACKAGE = __name__.split(".")[0]


def make_mesh(axis_sizes: dict):
    """A `DeviceMesh` over the default group with named dims: `axis_sizes`
    maps dim name -> size, e.g. {"data": 4, "model": 2}, ranks laid out in
    row-major order.  Raises ValueError unless the world size is the
    product of the sizes."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torchrun, or spawn_ranks)")
    from torch.distributed.device_mesh import DeviceMesh

    names, sizes = tuple(axis_sizes), tuple(int(s) for s in
                                            axis_sizes.values())
    total = math.prod(sizes)
    world = dist.get_world_size()
    if world != total:
        raise ValueError(f"the mesh {dict(axis_sizes)} needs {total} ranks, "
                         f"the process group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(total).reshape(sizes),
                      mesh_dim_names=names)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


@dataclass(frozen=True)
class NamedSharding:
    """A partition spec over a mesh's named dims (JAX's `NamedSharding`):
    entry i names the mesh dim that splits array dim i, or is None."""
    mesh: object
    spec: tuple

    def local(self, array: np.ndarray) -> np.ndarray:
        """This rank's block of the full `array`."""
        out = np.asarray(array)
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            k = axis_size(self.mesh, axis)
            i = self.mesh.get_local_rank(axis)
            step = out.shape[dim] // k
            out = np.take(out, np.arange(i * step, (i + 1) * step), axis=dim)
        return np.ascontiguousarray(out)


def named_sharding(mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(spec))


# ------------------------------------------------------------ collectives --

def comm_device(group) -> torch.device:
    """Where a transfer over `group` takes its tensors: the rank's current
    CUDA device under NCCL, the host under Gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def group_position(group):
    """(this rank's index in `group`, the group's global ranks)."""
    ranks = dist.get_process_group_ranks(group)
    return ranks.index(dist.get_rank()), ranks


def shift_down(t: torch.Tensor, group):
    """Rank i of `group` sends `t` to rank i + 1 and receives rank i - 1's
    tensor of the same shape and dtype, in one paired send and receive;
    returns it on `t`'s device (None on rank 0)."""
    i, ranks = group_position(group)
    cd = comm_device(group)
    ops, recv = [], None
    if i + 1 < len(ranks):
        ops.append(dist.P2POp(dist.isend, t.to(cd).contiguous(),
                              ranks[i + 1], group))
    if i > 0:
        recv = torch.empty(t.shape, dtype=t.dtype, device=cd)
        ops.append(dist.P2POp(dist.irecv, recv, ranks[i - 1], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return None if recv is None else recv.to(t.device)


def all_gather(t: torch.Tensor, group) -> list:
    """Every rank's `t` (same shape and dtype on every rank), in the
    group's order, on `t`'s device."""
    cd = comm_device(group)
    src = t.to(cd).contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


def all_gather_arrays(arrays, group) -> list:
    """Every rank's list of numpy `arrays` (the same shapes and dtypes on
    every rank), in the group's order: one all-gather of their bytes."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    flat = np.concatenate([a.reshape(-1).view(np.uint8) for a in arrays])
    parts = all_gather(torch.from_numpy(flat), group)
    out = []
    for part in parts:
        buf, pos, got = part.cpu().numpy(), 0, []
        for a in arrays:
            got.append(buf[pos:pos + a.nbytes].view(a.dtype).reshape(a.shape))
            pos += a.nbytes
        out.append(got)
    return out


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's `t` over `group`, a new tensor on `t`'s
    device (the same values on every rank)."""
    buf = t.detach().to(comm_device(group), copy=True).contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


# ------------------------------------------------------------------ ranks --

def check_group(fail_rank: int = -1):
    """A probe of the process group: (this rank, the world size, the sum of
    every rank's number over one all-reduce).  Rank `fail_rank` raises
    before the all-reduce, which leaves the others waiting in it (how a
    failing rank's error and the others' stop are checked)."""
    rank = dist.get_rank()
    if rank == fail_rank:
        raise RuntimeError(f"rank {rank} failed on purpose")
    total = all_reduce(torch.tensor([rank], dtype=torch.int64), None)
    return rank, dist.get_world_size(), int(total)


def run_calls(calls):
    """Runs each (function, args, kwargs) of `calls` in order: several of
    this package's rank functions in one group, so that its ranks start
    once.  Returns (result, seconds) of each."""
    for fn, _, _ in calls:
        _check_package(fn)
    out = []
    for fn, args, kwargs in calls:
        t0 = time.perf_counter()
        result = fn(*args, **(kwargs or {}))
        out.append((result, time.perf_counter() - t0))
    return out


def loaded_modules(prefixes, then=None, args=(), kwargs=None):
    """Runs `then(*args, **kwargs)` where given, then returns the names of
    this process's loaded modules that are, or lie inside, one of the
    packages `prefixes` (what a rank has imported)."""
    if then is not None:
        then(*args, **(kwargs or {}))
    return sorted(m for m in sys.modules
                  if any(m == p or m.startswith(p + ".") for p in prefixes))


def _check_package(fn):
    if getattr(fn, "__module__", "").split(".")[0] != PACKAGE:
        raise ValueError(f"ranks run functions of {PACKAGE} only, not "
                         f"{getattr(fn, '__module__', fn)!r}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_placement(device, rank: int, n_ranks: int):
    """(backend, device) of rank `rank` of the `n_ranks` ranks on one host
    asked to run on `device`: "cpu" -> Gloo on the host; "cuda:k" -> Gloo
    with every rank on card k; "cuda" -> NCCL with rank r on card r where
    the host has a card for each rank, else Gloo with every rank on card 0."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", dev
    if dev.index is None and torch.cuda.device_count() >= n_ranks:
        return "nccl", torch.device("cuda", rank)
    return "gloo", torch.device("cuda", dev.index or 0)


def _rank_main(fn, rank, n, device, port, timeout, args, kwargs, results):
    """One spawned rank: joins the group, runs `fn(*args, **kwargs)`,
    reports its result or its traceback on `results`, and leaves the
    group.  A failure is reported before the group is left: leaving it
    fails the other ranks' collectives too."""
    torch.set_num_threads(1)
    try:
        backend, dev = rank_placement(device, rank, n)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=n,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        out = fn(*args, **kwargs)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank, True, out))


def _failures(rank, n, value, results, grace: float = 1.0) -> str:
    """The report of rank `rank`'s failure and of any other rank's within
    `grace` seconds, in the order they came (a rank's exit can fail the
    others' collectives: the first report is the cause)."""
    lines = [f"rank {rank} of {n} failed:\n{value}"]
    deadline = time.monotonic() + grace
    while True:
        try:
            r, ok, v = results.get(
                timeout=max(0.0, deadline - time.monotonic()))
        except queue_mod.Empty:
            return "\n".join(lines)
        if not ok:
            lines.append(f"then rank {r} of {n} failed:\n{v}")


def _stop(procs):
    """Terminates the ranks still running, then kills any left."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def spawn_ranks(fn, n: int, *, device="cuda", timeout: float = 600.0,
                args=(), kwargs=None):
    """Runs `fn(*args, **kwargs)` on n ranks of one process group, each a
    process started with the `spawn` method, and returns their results in
    rank order.

    `fn` must be a module-level function of this package, so that a rank
    imports nothing else of its caller.  Each rank runs torch on one thread
    (`OMP_NUM_THREADS=1` in its environment); `device` places the ranks
    and picks the backend (`rank_placement`; "cpu" for the host).  The group
    meets at a free port of 127.0.0.1.  A rank that raises fails the call
    with its traceback, as does a rank that ends without a result or a run
    longer than `timeout` seconds; the other ranks are then terminated, and
    no rank outlives the call."""
    _check_package(fn)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, str(device), port, timeout,
                               tuple(args), dict(kwargs or {}), results))
             for r in range(n)]
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for p in procs:
            p.start()
    finally:
        if saved is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < n:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # A rank may have exited just after its put: one more
                    # look at the queue before calling it lost.
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} ended with exit code "
                            f"{procs[dead[0]].exitcode} and no result") \
                            from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks of {fn.__qualname__} "
                                       f"ran past {timeout} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(_failures(rank, n, value, results))
            out[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        _stop(procs)
        results.close()
    return [out[r] for r in range(n)]
