"""The port's fused unit trial against the JAX package's, with zero
tolerance.

The JAX side is `unit_fused.trial_apply(..., impl="xla")`, the inline twin
its own tests run on the CPU.  The port's plain PyTorch trial must give
the same cost (bit for bit), mode, reconstruction, levels and CABAC bin
counts, for every unit size, random and worst-case residuals, and nonzero
live rate-state rows (which the JAX package's own tests never feed).  It
runs once from the port's tables and once from the JAX package's tables,
so a difference in the tables and one in the math show up apart.  With a
PNN prediction the trial is held under both NN policies, `sub18` (it
replaces mode 18) and `append` (it is the 36th mode, PNNS), for every
unit size.  The CUDA kernel is held against the plain trial in
`tests/test_torch_cuda.py`.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from context_adaptive_neural_network_based_prediction_tpu.codec import rdo
from context_adaptive_neural_network_based_prediction_tpu.ops import (
    transform, unit_fused as j_unit_fused)
from context_adaptive_neural_network_based_prediction_tpu.parallel import (
    rate_model)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    unit_fused as t_unit_fused)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    wavefront2 as t_wavefront2)

from test_unit_fused import make_size_consts

GROUPS = {4: 1, 8: 1, 16: 6, 32: 36}
CASES = [(4, 22), (4, 37), (8, 27), (8, 42), (16, 32), (32, 32)]
NN_CASES = [(n, policy) for n in (4, 8, 16, 32)
            for policy in ("sub18", "append")]
NN_QP = 37
FIELDS = ("cost", "best", "rec", "q", "counts")
B = 12


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    # The suite runs in several worker processes; keep torch from
    # oversubscribing the cores.
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def trial_inputs(n, qp, b=B):
    """Seeded inputs: random content near a base level (slots 0-7) and
    worst-case residuals (slots 8-11: flat 255 against zero references,
    checkerboard, column stripes, zero against 255 references); live
    rate-state rows zero for even slots, random for odd ones."""
    rng = np.random.default_rng(1000 * n + qp)
    base = rng.integers(0, 256, (b, 1))
    rt = np.clip(base + rng.integers(-60, 60, (b, 2 * n + 1)), 0, 255)
    rl = np.clip(base + rng.integers(-60, 60, (b, 2 * n + 1)), 0, 255)
    og = np.clip(base[:, :, None] + rng.integers(-70, 70, (b, n, n)), 0, 255)
    yy, xx = np.mgrid[0:n, 0:n]
    rt[8:11], rl[8:11] = 0, 0
    og[8], og[9], og[10] = 255, 255 * ((yy + xx) % 2), 255 * (xx % 2)
    rt[11], rl[11], og[11] = 255, 255, 0
    rl[:, 0] = rt[:, 0]
    mb = rng.uniform(1.0, 6.0, (b, 35)).astype(np.float32)
    rr = rng.integers(-400, 400, (8, b))
    rr[:, 0::2] = 0
    return [np.ascontiguousarray(x, dtype=t) for x, t in
            ((rt, np.int32), (rl, np.int32), (og, np.int32),
             (mb, np.float32), (rr, np.int32))]


def consts(n, qp, tables, nn_policy=None):
    SB = rate_model.scalar_bits(qp)
    lam = rdo.lambda_for_qp(qp)
    qs = transform.QUANT_SCALES[qp % 6]
    iqs = transform.INV_QUANT_SCALES[qp % 6]
    n_modes = 36 if nn_policy == "append" else 35
    if tables == "jax":
        mod, c = j_unit_fused, make_size_consts(n, qp, n_modes)
    else:
        mod, c = t_unit_fused, t_wavefront2._unit_consts(n, qp, n_modes)
    return mod.build_consts(n, n_modes, c, SB, lam, qs, iqs, b_eff=B,
                            nn_policy=nn_policy, groups=GROUPS[n])


def nn_inputs(n, policy):
    """trial_inputs with a mode-bit row per mode (36 under append) and a
    PNN prediction: the original plus small noise in slots 0-5 (so the PNN
    mode wins there), random content in slots 6-9, 0 and 255 in the last
    two."""
    rt, rl, og, _, rr = trial_inputs(n, NN_QP)
    rng = np.random.default_rng(77 * n + len(policy))
    n_modes = 36 if policy == "append" else 35
    mb = rng.uniform(1.0, 6.0, (B, n_modes)).astype(np.float32)
    nnp = np.clip(og + rng.integers(-3, 4, og.shape), 0, 255)
    nnp[6:10] = rng.integers(0, 256, (4, n, n))
    nnp[10], nnp[11] = 0, 255
    return rt, rl, og, mb, rr, nnp.astype(np.int32)


@pytest.fixture(scope="module")
def jax_nn_results():
    out = {}
    for n, policy in NN_CASES:
        rt, rl, og, mb, rr, nnp = nn_inputs(n, policy)
        got = j_unit_fused.trial_apply(
            consts(n, NN_QP, "jax", policy), jnp.asarray(rt),
            jnp.asarray(rl), jnp.asarray(og), jnp.asarray(mb),
            jnp.asarray(nnp), impl="xla", rate_rows=jnp.asarray(rr))
        out[(n, policy)] = [np.asarray(x) for x in got]
    return out


@pytest.fixture(scope="module")
def port_nn_results():
    out = {}
    for n, policy in NN_CASES:
        rt, rl, og, mb, rr, nnp = [torch.from_numpy(x)
                                   for x in nn_inputs(n, policy)]
        for tables in ("port", "jax"):
            tc = t_unit_fused.consts_from_numpy(
                consts(n, NN_QP, tables, policy), device="cpu")
            got = t_unit_fused.trial_apply(tc, rt, rl, og, mb, rr,
                                           nn_pred=nnp)
            out[(n, policy, tables)] = [x.numpy() for x in got]
    return out


@pytest.fixture(scope="module")
def jax_results():
    """One JAX trial call per case (the costly side, run once)."""
    out = {}
    for n, qp in CASES:
        rt, rl, og, mb, rr = trial_inputs(n, qp)
        got = j_unit_fused.trial_apply(
            consts(n, qp, "jax"), jnp.asarray(rt), jnp.asarray(rl),
            jnp.asarray(og), jnp.asarray(mb), None, impl="xla",
            rate_rows=jnp.asarray(rr))
        out[(n, qp)] = [np.asarray(x) for x in got]
    return out


@pytest.fixture(scope="module")
def port_results():
    out = {}
    for n, qp in CASES:
        args = [torch.from_numpy(x) for x in trial_inputs(n, qp)]
        for tables in ("port", "jax"):
            tc = t_unit_fused.consts_from_numpy(consts(n, qp, tables),
                                                device="cpu")
            got = t_unit_fused.trial_apply(tc, *args)
            out[(n, qp, tables)] = [x.numpy() for x in got]
    return out


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("tables", ["port", "jax"])
@pytest.mark.parametrize("n,qp", CASES)
def test_trial_matches_jax(jax_results, port_results, n, qp, tables, field):
    """Zero tolerance: integer outputs exactly, the float32 cost bit for
    bit (no multiply-add of the JAX CPU build is contracted, so no ulp
    allowance is needed)."""
    i = FIELDS.index(field)
    want = jax_results[(n, qp)][i]
    got = port_results[(n, qp, tables)][i]
    assert got.shape == want.shape and got.dtype == want.dtype
    if field == "cost":
        want, got = want.view(np.int32), got.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=f"{field} n={n}")


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("tables", ["port", "jax"])
@pytest.mark.parametrize("n,policy", NN_CASES)
def test_trial_with_nn_pred_matches_jax(jax_nn_results, port_nn_results, n,
                                        policy, tables, field):
    """Zero tolerance, as above, with the PNN prediction in mode 18
    (`sub18`) or in the 36th mode (`append`)."""
    i = FIELDS.index(field)
    want = jax_nn_results[(n, policy)][i]
    got = port_nn_results[(n, policy, tables)][i]
    assert got.shape == want.shape and got.dtype == want.dtype
    if field == "cost":
        want, got = want.view(np.int32), got.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=f"{field} n={n}")


@pytest.mark.parametrize("n,policy", NN_CASES)
def test_nn_mode_is_chosen(port_nn_results, n, policy):
    """The near-perfect PNN predictions of slots 0-5 win there, so the
    comparisons above cover the PNN mode's whole trial."""
    best = port_nn_results[(n, policy, "port")][1]
    assert (best[:6] == (18 if policy == "sub18" else 35)).any()


def test_rate_rows_change_decisions(port_results):
    """The live rate rows are not inert: the slots with nonzero rows pay
    other costs than they would with zero rows."""
    n, qp = 8, 27
    rt, rl, og, mb, rr = trial_inputs(n, qp)
    tc = t_unit_fused.consts_from_numpy(consts(n, qp, "port"), device="cpu")
    args = [torch.from_numpy(x) for x in (rt, rl, og, mb)]
    zero = t_unit_fused.trial_apply(tc, *args)[0].numpy()
    live = port_results[(n, qp, "port")][0]
    assert np.array_equal(zero[0::2], live[0::2])
    assert not np.array_equal(zero[1::2], live[1::2])


def test_cpu_tensors_run_the_plain_trial(monkeypatch):
    n, qp = 4, 37
    tc = t_unit_fused.consts_from_numpy(consts(n, qp, "port"), device="cpu")
    args = [torch.from_numpy(x) for x in trial_inputs(n, qp)]

    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(t_unit_fused, "_kernel_trial", no_kernel)
    t_unit_fused.reset_launch_counts()
    a = t_unit_fused.trial_apply(tc, *args)
    b = t_unit_fused.trial_apply(tc, *args, impl="plain")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert t_unit_fused.launches == {4: 0, 8: 0, 16: 0, 32: 0}
    with pytest.raises(ValueError, match="impl"):
        t_unit_fused.trial_apply(tc, *args, impl="fast")


def test_i32_sum_wraps_like_int32():
    x = torch.tensor([[2 ** 30, 2 ** 30, 2 ** 30], [-5, 7, 1]],
                     dtype=torch.int32)
    want = np.sum(x.numpy(), axis=0, dtype=np.int32, keepdims=True)
    got = t_unit_fused._i32_sum(x, 0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_table_block_holds_every_table(n):
    """`consts_from_numpy` puts the kernel's tables in one block: each
    table at its offset (16-byte aligned) with its values, the `k_*`
    tensors views of the block, and the kernel's `TableSet` pointing at
    each table, with the scalar parameters by value; the tables only the
    n = 16 / 32 kernel reads exist at n > 8 only (null pointers below);
    at n > 8 the rate tables are one row (every mode's); a call's output
    buffer holds the outputs and nothing else at every n."""
    cst = consts(n, 32, "port")
    tc = t_unit_fused.consts_from_numpy(cst, device="cpu")
    block, layout = tc["k_block"], tc["k_layout"]
    assert block.dtype == torch.int32 and block.is_contiguous()
    keys = t_unit_fused.table_keys(n)
    assert set(keys) == set(t_unit_fused.TABLE_KEYS) - (
        set() if n > 8 else set(t_unit_fused.LARGE_TABLE_KEYS))
    assert set(layout) == set(keys + t_unit_fused.PARAM_KEYS)
    words = block.numpy()
    for k, (off, shape, dtype) in layout.items():
        want = np.ascontiguousarray(cst[k])
        assert off % 4 == 0 and shape == want.shape and dtype == want.dtype
        got = words[off:off + want.size].view(dtype).reshape(shape)
        np.testing.assert_array_equal(got, want, err_msg=k)
        np.testing.assert_array_equal(tc[k].numpy(), want, err_msg=k)
        assert tc[k].data_ptr() == block.data_ptr() + 4 * off
    st = tc["k_struct"]
    for k in t_unit_fused.TABLE_KEYS:
        want = tc[k].data_ptr() if k in keys else None
        assert getattr(st, k[2:]) == want, k
    np.testing.assert_array_equal(np.array(st.ip[:]), cst["k_iparams"])
    np.testing.assert_array_equal(np.array(st.fp[:], np.float32),
                                  cst["k_fparams"])
    assert tc["k_struct_ptr"] == ctypes.addressof(st)
    assert tc["k_device"] == block.device
    if n > 8:
        assert cst["k_iparams"][1] == 1 and cst["k_scan"].shape == (1, n * n)
    assert t_unit_fused.out_words(n, 31) == 31 * (2 + 2 * n * n + 8)


def fused_select(cost, n_modes):
    """The kernel's select, in plain PyTorch: per slot, lane l of one warp
    holds the costs of modes l and l + 32 (+inf past the last mode); the
    warp's float minimum, then the least mode id whose cost equals it."""
    b = cost.shape[0]
    inf = torch.full((b, 64 - n_modes), float("inf"))
    c = torch.cat([cost[:, :n_modes], inf], dim=1)       # (b, 64)
    c0, c1 = c[:, :32], c[:, 32:]
    v = torch.minimum(c0, c1).amin(dim=1, keepdim=True)
    lanes = torch.arange(32)[None]
    ids = torch.where(c0 == v, lanes, torch.where(c1 == v, lanes + 32,
                                                   t_unit_fused.M_PAD))
    best = ids.amin(dim=1)
    return cost.gather(1, best[:, None])[:, 0], best


@pytest.mark.parametrize("n_modes", [35, 36])
def test_fused_select_matches_argmin_blocks(n_modes):
    """Ties (several modes at the minimum, +0 and -0) go to the lowest mode
    id, as `_argmin_blocks` decides, also beside infinite costs; the cost
    returned is that mode's own."""
    rng = np.random.default_rng(n_modes)
    b = 64
    cost = rng.integers(0, 6, (b, t_unit_fused.M_PAD)).astype(np.float32)
    cost[:8] = 3.0
    cost[8:16, 5] = -0.0
    cost[8:16, 2] = 0.0
    cost[16:24, ::2] = np.inf
    cost[24:32, n_modes:] = -1.0          # past the last mode: never read
    cost[32:40, 33:] = -2.0 if n_modes == 36 else 7.0
    cost[:, n_modes:] = np.where(np.arange(b)[:, None] < 24, 99.0,
                                 cost[:, n_modes:])
    t = torch.from_numpy(cost)
    got_v, got_b = fused_select(t, n_modes)
    # _argmin_blocks' lane layout: (1, M * B), mode-major; modes past the
    # last carry the plain trial's BIG_COST.
    lanes = t.clone()
    lanes[:, n_modes:] = t_unit_fused.BIG_COST
    z = torch.zeros((1, t_unit_fused.M_PAD * b), dtype=torch.int32)
    want_v, want_b, _, _, _ = t_unit_fused._argmin_blocks(
        lanes.T.reshape(1, -1), z, z, z, b)
    assert torch.equal(got_b.to(torch.int32), want_b)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert (got_b[:8] == 0).all() and (got_b[8:16] <= 2).all()


@pytest.mark.parametrize("bad", ["ref_top_dtype", "orig_shape", "mode_bits",
                                 "rate_rows", "nn_pred", "layout",
                                 "no_tables"])
def test_kernel_wrapper_refuses_bad_inputs(bad):
    """The kernel path checks its inputs with one predicate per call and
    raises before it builds or launches anything."""
    n, qp = 8, 32
    tc = t_unit_fused.consts_from_numpy(consts(n, qp, "port"), device="cpu")
    rt, rl, og, mb, rr = [torch.from_numpy(x) for x in trial_inputs(n, qp)]
    nnp = None
    if bad == "ref_top_dtype":
        rt = rt.to(torch.int64)
    elif bad == "orig_shape":
        og = og[:, :4].contiguous()
    elif bad == "mode_bits":
        mb = torch.cat([mb, mb[:, :1]], dim=1)
    elif bad == "rate_rows":
        rr = rr.T.contiguous()
    elif bad == "nn_pred":
        nnp = og.to(torch.int16)
    elif bad == "layout":
        rl = rl.T.contiguous().T
    else:
        tc = t_unit_fused.consts_from_numpy(
            consts(n, qp, "jax"), device="cpu")
    with pytest.raises(ValueError):
        t_unit_fused._kernel_trial(tc, rt, rl, og, mb, rr, nnp)
