"""The v1 wavefront step on the card: the wrapper of the hand-written CUDA
kernel of `csrc/v1_step.cu`.

One launch codes every block of one step of `parallel/wavefront.run`:
references, the 35 predictions, transforms, quantisation, cost, the
first minimum and the commit, equal bit for bit to the plain PyTorch
`wavefront._step` (which the CPU keeps).  It replaces no TPU kernel: the
JAX package leaves this step to XLA.

* `stepper(plan, dp, st)`: checks the encode's state and tables once and
  returns `step(t)`, which launches the kernel for step t on the current
  stream (a failed build or launch raises; nothing falls back).  It takes
  CUDA tensors only.
* `launches[n]` counts the launches per block size n, where the wrapper
  launches; each launch also adds 1 to the tracer's `v1.step_kernel`
  counter (`utils/profiling.count`) while tracing is active.
* `blocks_on_frame(plan, t)`: the blocks of step t inside one frame; the
  grid is that times the frames (slots off the frame are not launched).
"""

from __future__ import annotations

import torch

from ..utils.profiling import count
from . import _cuda_build, transform

# Launches of the CUDA kernel, per block size n, counted where the wrapper
# launches it.  `reset_launch_counts` empties it.
launches: dict = {}


def reset_launch_counts():
    launches.clear()


def blocks_on_frame(plan, t: int) -> int:
    """The blocks (by, bx = t - 2 by) of step t inside the frame: by from
    the step's first row in the schedule (`_build_plan`) up to the last
    one with bx >= 0."""
    if not 0 <= t < plan["n_steps"]:
        raise ValueError(f"step {t} outside 0..{plan['n_steps'] - 1}")
    first = max(0, -((plan["nbx"] - 1 - t) // 2))
    return min(plan["nby"] - 1, t // 2) - first + 1


def kernel_args(plan, dp, st) -> tuple:
    """The kernel's arguments after (n, blocks, t), fixed over an encode:
    the plan's scalars, then the pointers of the state and the tables.
    Raises ValueError unless every tensor is contiguous, of its dtype and
    shape (the tables' as the plan has them), on the device of
    `st["recon"]`."""
    n, nf = plan["n"], plan["n_frames"]
    dev = st["recon"].device
    size, cells = nf * plan["plane"], nf * plan["cells"]
    for name, t, shape, dtype in (
            ("frame", st["frame"], (size,), torch.int32),
            ("recon", st["recon"], (size,), torch.int32),
            ("modes", st["modes"], (cells,), torch.int32),
            ("qcoeffs", st["qcoeffs"], (cells, n * n), torch.int32),
            ("rate", dp["rate"], plan["rate"].shape, torch.float32),
            ("mode_bits", dp["mode_bits"], plan["mode_bits"].shape,
             torch.float32)):
        _cuda_build.check_tensor(name, t, shape, (dtype,), dev)
    per, rem = plan["qp"] // 6, plan["qp"] % 6
    dq_shift = transform.IQUANT_SHIFT - (
        transform.transform_shift(n.bit_length() - 1) + per)
    use_filtered = sum(1 << m for m, on in enumerate(plan["use_filtered"])
                       if on)
    return (nf, plan["width"], plan["height"], plan["top"],
            int(plan["has_halo"]), plan["nbx"], plan["nby"], plan["plane"],
            plan["cells"], plan["qscale"], plan["qbits"], plan["qadd"],
            transform.INV_QUANT_SCALES[rem], dq_shift, use_filtered,
            float(plan["lam"]), st["frame"].data_ptr(),
            st["recon"].data_ptr(), st["modes"].data_ptr(),
            st["qcoeffs"].data_ptr(), dp["rate"].data_ptr(),
            dp["mode_bits"].data_ptr())


def stepper(plan, dp, st):
    """`step(t)`: one launch of the kernel for step t of the encode whose
    plan, device tables and state (`wavefront._state`) are given.  Raises
    ValueError, launching nothing, unless the state and tables are CUDA
    tensors as `kernel_args` wants them."""
    dev = st["recon"].device
    if dev.type != "cuda":
        raise ValueError(f"v1_step: the kernel takes CUDA tensors, got "
                         f"{dev}")
    args = kernel_args(plan, dp, st)
    fn = _cuda_build.library("v1_step").v1_step
    n, nf, idx = plan["n"], plan["n_frames"], dev.index

    def step(t: int):
        blocks = blocks_on_frame(plan, t) * nf
        err = fn(n, blocks, t, *args,
                 torch._C._cuda_getCurrentRawStream(idx))
        if err != 0:
            raise RuntimeError(
                f"v1_step kernel (n={n}, step {t}, {blocks} blocks) failed: "
                f"{_cuda_build.error_string('v1_step', err)}")
        launches[n] = launches.get(n, 0) + 1
        count("v1.step_kernel", 1)

    return step
