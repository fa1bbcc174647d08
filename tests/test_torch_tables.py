"""The PyTorch port's tables equal the JAX package's, array for array.

Covers the numpy tables the port keeps its own copies of: CABAC state and
context tables, the static rate model, the unit-trial constants
(`build_consts`), the wavefront geometry tables (`_coding_order4`,
`_fill_tables`), and every table the wavefront encoder builds for a frame
(`size_consts`, the rate-evolution LUTs, the scalar bits), the latter read
from the JAX package's built encoder, also under the NN policies with the
frozen singles zoo (the PNN-context tables `_nn_ctx_tables`, their
classes, the 36-mode rate tables and the trial constants of `sub18` and
`append`).
"""

import inspect
import os

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    cabac as j_cabac, contexts as j_contexts, nn_intra as j_nn_intra,
    rdo as j_rdo)
from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn_q as j_pnn_q)
from context_adaptive_neural_network_based_prediction_tpu.ops import (
    transform as j_transform, unit_fused as j_unit_fused)
from context_adaptive_neural_network_based_prediction_tpu.parallel import (
    rate_model as j_rate_model, wavefront2 as j_wavefront2)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    cabac as t_cabac, contexts as t_contexts, nn_intra as t_nn_intra,
    rdo as t_rdo)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    pnn_q as t_pnn_q)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    unit_fused as t_unit_fused)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    rate_model as t_rate_model, wavefront2 as t_wavefront2)

from test_unit_fused import make_size_consts

GROUPS = {4: 1, 8: 1, 16: 6, 32: 36}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def assert_same(a, b, what):
    """Equal values and dtype (numpy arrays) or equal scalars."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype, f"{what}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, dict):
        assert set(a) <= set(b), f"{what}: keys {set(a) - set(b)} missing"
        for k in a:
            assert_same(a[k], b[k], f"{what}[{k}]")
    else:
        assert a == b, f"{what}: {a!r} != {b!r}"


@pytest.mark.parametrize("name", ["LPS_TABLE", "RENORM_TABLE",
                                  "NEXT_STATE_MPS", "NEXT_STATE_LPS",
                                  "ENTROPY_BITS"])
def test_cabac_tables(name):
    assert_same(getattr(j_cabac, name), getattr(t_cabac, name), name)


@pytest.mark.parametrize("qp", [0, 22, 32, 37, 51])
def test_context_states(qp):
    assert_same(j_contexts.make_context_states(qp),
                t_contexts.make_context_states(qp), f"states qp {qp}")
    assert vars(j_contexts.OFFSETS) == vars(t_contexts.OFFSETS)
    assert j_rdo.lambda_for_qp(qp) == t_rdo.lambda_for_qp(qp)


@pytest.mark.parametrize("qp", [22, 27, 32, 37, 42])
def test_rate_model_scalars(qp):
    assert_same(j_rate_model.scalar_bits(qp), t_rate_model.scalar_bits(qp),
                "scalar_bits")
    assert_same(j_rate_model.mode_bits_table(qp),
                t_rate_model.mode_bits_table(qp), "mode_bits_table")


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("qp", [22, 32, 37])
def test_rate_model_tables(n, qp):
    for fn in ("sig_bits_tables", "last_bits_tables"):
        for i, (a, b) in enumerate(zip(getattr(j_rate_model, fn)(qp, n),
                                       getattr(t_rate_model, fn)(qp, n))):
            assert_same(a, b, f"{fn}[{i}]")
    for i, (a, b) in enumerate(zip(j_rate_model.scan_tables(n),
                                   t_rate_model.scan_tables(n))):
        assert_same(a, b, f"scan_tables[{i}]")


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("qp", [22, 32, 37])
def test_unit_consts_and_build_consts(n, qp):
    """The port's per-size constants and fused-trial constants equal the
    JAX package's (its test suite's transcription of the per-size bundle,
    then `build_consts` of each package)."""
    jc = make_size_consts(n, qp, 35)
    tc = t_wavefront2._unit_consts(n, qp)
    assert_same({k: v for k, v in jc.items()}, tc, "size consts")
    SB = j_rate_model.scalar_bits(qp)
    lam = j_rdo.lambda_for_qp(qp)
    qs = j_transform.QUANT_SCALES[qp % 6]
    iqs = j_transform.INV_QUANT_SCALES[qp % 6]
    want = j_unit_fused.build_consts(n, 35, jc, SB, lam, qs, iqs, b_eff=9,
                                     groups=GROUPS[n])
    got = t_unit_fused.build_consts(n, 35, tc, SB, lam, qs, iqs, b_eff=9,
                                    groups=GROUPS[n])
    assert_same({k: v for k, v in want.items() if k != "_pcall"}, got,
                "build_consts")


@pytest.mark.parametrize("h,w", [(64, 96), (128, 128), (96, 224)])
def test_coding_order(h, w):
    assert_same(j_wavefront2._coding_order4(h, w, 32),
                t_wavefront2._coding_order4(h, w, 32), "coding order")


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("h,w", [(64, 96), (128, 128), (96, 224)])
def test_fill_tables(h, w, n):
    for i, (a, b) in enumerate(zip(j_wavefront2._fill_tables(h, w, n, 32),
                                   t_wavefront2._fill_tables(h, w, n, 32))):
        assert_same(a, b, f"fill table {i}")


@pytest.fixture(scope="module")
def encoder_tables():
    """The tables of the JAX package's built encoder (64x96, QP 32, CTB
    32, NxN, rate evolution, fused trial), read from its closure, and the
    port's plan for the same frame."""
    old = os.environ.get("CANP_FUSED_UNIT")
    os.environ["CANP_FUSED_UNIT"] = "xla"
    try:
        run = j_wavefront2._build_wavefront2(
            64, 96, 32, 1.0, "regular", None, ctb=32, enable_nxn=True,
            n_frames=1, rate_evolve=True)
    finally:
        if old is None:
            del os.environ["CANP_FUSED_UNIT"]
        else:
            os.environ["CANP_FUSED_UNIT"] = old
    step = inspect.getclosurevars(run.__wrapped__).nonlocals["step"]
    jax_vars = inspect.getclosurevars(step).nonlocals
    plan = t_wavefront2._build_wavefront2(64, 96, 32, rate_evolve=True)
    return jax_vars, plan


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_encoder_size_consts(encoder_tables, n):
    jax_vars, plan = encoder_tables
    want = dict(jax_vars["size_consts"][n])
    want_fused = want.pop("fused")
    got = plan["size_consts"][n]
    assert_same(want, got, f"size_consts[{n}]")
    assert_same({k: v for k, v in want_fused.items() if k != "_pcall"},
                got["fused"], f"size_consts[{n}]['fused']")
    # The port gathers with `sel`; it must be the one-hot table's index.
    np.testing.assert_array_equal(got["onehot"].argmax(-1), got["sel"])


@pytest.mark.parametrize("name", ["RS_LUT0", "RS_LUT1", "RS_STAT0",
                                  "RS_STAT1", "MODE_BITS", "SB", "lam",
                                  "b_eff", "OFF", "OFF8", "WIN", "W_sk",
                                  "PH", "n_planes", "cu8", "sbx", "sby"])
def test_encoder_scalars_and_luts(encoder_tables, name):
    jax_vars, plan = encoder_tables
    assert_same(jax_vars[name], plan[name], name)
    assert jax_vars["RS_TMIN"] == t_wavefront2.RS_TMIN
    assert jax_vars["ROW0"] == t_wavefront2.ROW0


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("h,w", [(64, 96), (128, 128), (96, 224)])
def test_nn_ctx_tables(h, w, n):
    for i, (a, b) in enumerate(zip(
            j_wavefront2._nn_ctx_tables(h, w, n, 32),
            t_wavefront2._nn_ctx_tables(h, w, n, 32))):
        assert_same(a, b, f"nn ctx table {i}")


def closure_vars(fn):
    """The filled closure cells of `fn` by name (the NN step closes over
    cells that are still empty when the encoder is built)."""
    out = {}
    for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
        try:
            out[name] = cell.cell_contents
        except ValueError:
            pass
    return out


FROZEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "frozen")


@pytest.fixture(scope="module")
def nn_encoder_tables():
    """For each NN policy, the size_consts of the JAX package's built
    encoder (128x128, QP 32, CTB 32, NxN, fused trial) with the frozen
    singles zoo, and the port's plan for the same frame and bundle."""
    quantized = {w: j_pnn_q.load_quantized(os.path.join(
        FROZEN, f"qpnn_w{w}_single.npz")) for w in (4, 8, 16, 32)}
    j_bundle = j_nn_intra.PnnBundle(
        {}, {w: str(q["kind"]) == "fc" for w, q in quantized.items()},
        86.85680942771248, quantized=quantized)
    t_bundle = t_nn_intra.PnnBundle(
        {w: t_pnn_q.load_quantized(os.path.join(
            FROZEN, f"qpnn_w{w}_single.npz")) for w in (4, 8, 16, 32)},
        86.85680942771248)
    out = {}
    old = os.environ.get("CANP_FUSED_UNIT")
    os.environ["CANP_FUSED_UNIT"] = "xla"
    try:
        for policy in ("switch", "substitution"):
            run = j_wavefront2._build_wavefront2(
                128, 128, 32, 1.0, policy, j_bundle, ctb=32,
                enable_nxn=True, n_frames=1, rate_evolve=False)
            step = closure_vars(run.__wrapped__)["step"]
            jax_vars = closure_vars(step)
            plan = t_wavefront2._build_wavefront2(
                128, 128, 32, policy=policy, bundle=t_bundle)
            out[policy] = (jax_vars, plan)
    finally:
        if old is None:
            del os.environ["CANP_FUSED_UNIT"]
        else:
            os.environ["CANP_FUSED_UNIT"] = old
    return out


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("policy", ["switch", "substitution"])
def test_nn_encoder_size_consts(nn_encoder_tables, policy, n):
    jax_vars, plan = nn_encoder_tables[policy]
    assert plan["n_modes"] == jax_vars["n_modes"]
    assert plan["nn_widths"] == jax_vars["nn_widths"] == (4, 8, 16, 32)
    want = dict(jax_vars["size_consts"][n])
    want_fused = want.pop("fused")
    got = plan["size_consts"][n]
    assert_same(want, got, f"{policy} size_consts[{n}]")
    assert_same({k: v for k, v in want_fused.items() if k != "_pcall"},
                got["fused"], f"{policy} size_consts[{n}]['fused']")
    assert got["fused"]["nn_policy"] == (
        "append" if policy == "switch" else "sub18")


def test_schedule():
    for args in ((2, 3, 2, 5), (4, 4, 3, 10), (33, 60, 31, 124)):
        for a, b in zip(j_wavefront2._schedule(*args),
                        t_wavefront2._schedule(*args)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def batched_tables():
    """The JAX package's encoder built for 2 frames (96x128, QP 32, CTB
    32, NxN, switch with the frozen singles zoo; built, not compiled) and
    the port's plan and device plan (CPU) for the same."""
    quantized = {w: j_pnn_q.load_quantized(os.path.join(
        FROZEN, f"qpnn_w{w}_single.npz")) for w in (4, 8, 16, 32)}
    j_bundle = j_nn_intra.PnnBundle(
        {}, {w: str(q["kind"]) == "fc" for w, q in quantized.items()},
        86.85680942771248, quantized=quantized)
    t_bundle = t_nn_intra.PnnBundle(dict(quantized), 86.85680942771248)
    run = j_wavefront2._build_wavefront2(
        96, 128, 32, 1.0, "switch", j_bundle, ctb=32, enable_nxn=True,
        n_frames=2, rate_evolve=False)
    step = closure_vars(run.__wrapped__)["step"]
    plan = t_wavefront2._build_wavefront2(96, 128, 32, policy="switch",
                                          bundle=t_bundle, n_frames=2)
    return closure_vars(step), plan, t_wavefront2._device_plan(plan, "cpu")


def jax_slot_ids(jax_vars, t):
    """The JAX step's (by_ids, bx_ids) on the (slot, frame) axis at step t
    (`parallel/wavefront2.py:861-866`)."""
    nf, b_max, sbx = jax_vars["NF"], jax_vars["b_max"], jax_vars["sbx"]
    by0 = max(0, -((sbx - 1 - t) // 2))
    by_ids = by0 + np.repeat(np.arange(b_max), nf)
    return by_ids, t - 2 * by_ids


@pytest.mark.parametrize("name", ["NF", "b_eff", "b_max", "n_planes", "W_sk",
                                  "OFF", "PH"])
def test_batched_plan_scalars(batched_tables, name):
    jax_vars, plan, _ = batched_tables
    assert_same(jax_vars[name], plan["n_frames" if name == "NF" else name],
                name)
    assert plan["b_eff"] == 2 * plan["b_max"]


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_batched_per_slot_tables(batched_tables, n):
    """Every per-(slot, frame) table of the port's batched plan (reference
    selection, PNN context availability and masks, bx) equals what the JAX
    step gathers from its class maps (`refs_for_b` :894-897,
    `nn_predict_b` :976-982): each slot's entry repeated per frame."""
    jax_vars, plan, dp = batched_tables
    c = jax_vars["size_consts"][n]
    h, w, ctb = 96, 128, 32
    un = ctb // n
    for t in range(plan["n_steps"]):
        by_ids, bx_ids = jax_slot_ids(jax_vars, t)
        np.testing.assert_array_equal(dp["bx"][t].numpy(), bx_ids)
        for k, (ly, lx) in enumerate(t_wavefront2._z_offsets(ctb, n)):
            by_n = np.clip(by_ids * un + ly // n, 0, h // n - 1)
            bx_n = np.clip(bx_ids * un + lx // n, 0, w // n - 1)
            sel = c["onehot"][c["smap"][0, by_n, bx_n]].argmax(-1)
            np.testing.assert_array_equal(dp["sel"][n][t, k].numpy(), sel)
            cls = c["nn_cmap"][0, by_n, bx_n]
            nd = dp["nn"][n]
            np.testing.assert_array_equal(nd["ok"][t, k].numpy(),
                                          c["nn_ok_c"][cls])
            np.testing.assert_array_equal(nd["am"][t, k].numpy(),
                                          c["nn_am_c"][cls])
            np.testing.assert_array_equal(nd["lm"][t, k].numpy(),
                                          c["nn_lm_c"][cls])
