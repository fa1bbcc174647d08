"""The yardstick of the roofline and mfu metrics: the H100's published
peaks and the least time the card could take for a kernel's work,
computed from shapes alone.

A frozen copy of the bound arithmetic that `chip_smoke.py` uses for the
kernel table of PERF.md (its `HBM_BPS`, `F32_OPS`, `card_rates`,
`trial_bound_ms` and `merger_bound_ms`), rewritten on shapes so that a
change to a kernel or to its tables cannot move the yardstick it is
measured by.  The least time of a piece of work is the larger of its bytes
(inputs and tables read once, outputs written once) over the HBM rate and
its operations over the fastest route that computes them exactly.
"""

from __future__ import annotations

# H100 SXM (NVIDIA's data sheet, dense rates, 700 W): HBM 3.35 TB/s; 67
# T/s for float32 outside the tensor cores.  The int32 and FP64
# tensor-core rates are read from the card: 64 int32 lanes and 256 FP64
# tensor-core operations a clock per SM, a multiply-add counted as two.
HBM_BPS = 3.35e12
F32_OPS = 67e12
INT32_LANES_PER_SM = 64
F64_TC_OPS_PER_SM_CLOCK = 256
# Float32 operations a pixel of a trial, beside its transforms: prediction,
# RDOQ, rate, sign hiding and reconstruction (chip_smoke.py's count).
TRIAL_F32_OPS_PER_PIXEL = 72
# The trial's tables: per n, int32 (or float32) words of the kernel's table
# block (`unit_fused.TABLE_KEYS` and `PARAM_KEYS` of the port at the time
# the yardstick was frozen): rows is 36 mode rows at n <= 8, one shared
# row at n > 8.
M_PAD = 36


def card_rates(sms: int, max_sm_mhz: float):
    """(int32, FP64 tensor-core) operations per second of a card with `sms`
    SMs at `max_sm_mhz` (its `nvidia-smi --query-gpu=clocks.max.sm`)."""
    clock = sms * max_sm_mhz * 1e6
    return 2 * INT32_LANES_PER_SM * clock, F64_TC_OPS_PER_SM_CLOCK * clock


def trial_table_bytes(n: int) -> int:
    """Bytes of the unit trial's tables of size n, read once a launch."""
    nn = n * n
    rows = M_PAD if n <= 8 else 1
    words = (3 * 33 * nn            # angular gathers and fractions
             + 35                   # filter choice per mode
             + 2 * nn               # forward and inverse matrices
             + 5 * rows * nn        # scan, sig0 / sig1 (float and micro-bits)
             + nn                   # last-position bits
             + 16 + 8)              # integer and float parameters
    if n > 8:
        words += rows * nn + 33 * nn   # inverse scan, packed angular words
    return 4 * words


def trial_least_s(n: int, b: int, n_modes: int, rates, *,
                  rate_rows: bool = True, nn_pred: bool = False):
    """(seconds, "bytes" or "operations", route) of one unit-trial launch
    over b units of size n trying n_modes modes.  Operations: the four
    integer transform passes, 2 n^3 multiply-adds a (unit, mode), by the
    faster exact route (int32 on the CUDA cores or FP64 on the tensor
    cores), against 72 float32 operations a pixel at the float32 rate; the
    two run on separate units, so the larger bounds."""
    int_ops, f64_ops = rates
    nn = n * n
    read = (b * (2 * n + 1) * 4 * 2 + b * nn * 4 + b * n_modes * 4
            + (8 * b * 4 if rate_rows else 0) + (b * nn * 4 if nn_pred else 0)
            + trial_table_bytes(n))
    written = b * 4 * 2 + b * nn * 4 * 2 + b * 8 * 4
    t_bytes = (read + written) / HBM_BPS
    transform_ops = b * n_modes * 4 * 2 * n ** 3
    routes = {"int32": transform_ops / int_ops,
              "f64 tensor cores": transform_ops / f64_ops}
    route = min(routes, key=routes.get)
    t_f32 = b * n_modes * TRIAL_F32_OPS_PER_PIXEL * nn / F32_OPS
    if t_f32 > routes[route]:
        route = "f32 operations"
    t_ops = max(routes[route] if route in routes else 0.0, t_f32)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", route)


def merger_int_least_s(n: int, p: int, o: int, m: int, rates):
    """(seconds, "bytes" or "operations") of one integer-merger launch: x
    (N, P, M) int16, w (P, O, M) int16 and b (O, M) int32 read once, the
    (M, N, O) int32 output written once, against N P O M multiply-adds at
    the card's int32 rate."""
    int_ops, _ = rates
    moved = n * p * m * 2 + p * o * m * 2 + o * m * 4 + m * n * o * 4
    t_bytes = moved / HBM_BPS
    t_ops = 2 * n * p * o * m / int_ops
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def contraction_least_s(n_out: int, k: int, c_out: int, in_bytes: int,
                        w_bytes: int, out_bytes: int, rates) -> float:
    """Least time of an exact integer contraction (a convolution or FC
    layer): n_out outputs a channel, each a sum of k products, c_out
    channels, by the faster exact route (int32 CUDA cores or FP64 tensor
    cores: every sum stays below 2^31), against its bytes."""
    int_ops, f64_ops = rates
    ops = 2 * n_out * k * c_out
    return max((in_bytes + w_bytes + out_bytes) / HBM_BPS,
               ops / max(int_ops, f64_ops))
