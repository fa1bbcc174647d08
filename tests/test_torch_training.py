"""The port's PNN training against the JAX package's, on the CPU.

From a JAX `init_state` carried across (params and Adam state as numpy,
`training.state_from_numpy`), at small sizes (batch 8; FC w4, conv w8 and
w16), with the tolerances stated per test:

* losses: each term and `total_loss` within 1e-6 relative of JAX's, the
  argument checks;
* gradients per leaf within 1e-5 of the leaf's max |g| (float32 sums in
  another order) in 98% of its entries and within 5e-2 in all (a LeakyReLU
  input within rounding of 0 may take the other slope);
* Adam on identical gradients: params and moments within 2 ulps of
  optax's (equal in practice), at counts on either side of every LR
  boundary;
* the LR schedule equal to `optax.piecewise_constant_schedule` (float32)
  at b - 1, b and b + 1 of every boundary, and across a resume that
  straddles one;
* 5-step loss trajectories within 1e-5 relative, with fixed masks and
  with the masks JAX drew (recomputed from its keys and passed to the
  port), across LR boundaries.  Params after a step are not held to one
  tight tolerance: an entry with a near-zero gradient moves by about
  lr g / (|g| + 1e-8), so a last-bit difference in g can move it by up to
  2 lr;
* `train_chunk` equal to K `train_step`s, checkpoint round trips and a
  resumed run equal to an uninterrupted one, bit for bit; a JAX-written
  checkpoint restored and stepped in the port against the JAX step after
  it;
* the port's init (names, shapes, zero biases, each leaf's sample std
  within 5% of the JAX package's constant) and its own mask draw;
* the float kernel wrappers refuse tensors that require grad, and the
  serving forward after a step sees the updated weights.

JAX's `train_step` is compiled once per configuration and shared through
module-scoped fixtures.
"""

import math
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from context_adaptive_neural_network_based_prediction_tpu.models import (
    losses as j_losses, pnn as j_pnn, training as j_training)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    losses as t_losses, pnn as t_pnn, training as t_training, zoo as t_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    fc_forward, merger)

MEAN = 86.8568
N = 8
CONFIGS = [(4, True), (8, False), (16, False)]
IDS = ["fc_w4", "conv_w8", "conv_w16"]
TOTAL = 8          # boundaries at 4, 6 and 7: five steps cross two
COEFFS = dict(coeff_l2=1.0, coeff_grad=0.5)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


def jax_blob(state):
    return {"params": jax.device_get(state.params),
            "opt_state": jax.device_get(state.opt_state),
            "step": int(state.step)}


def batch(w, seed, n=N):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, w, 3 * w, 1), dtype=np.uint8),
            rng.integers(0, 256, (n, 2 * w, w, 1), dtype=np.uint8),
            rng.integers(0, 256, (n, w, w, 1), dtype=np.uint8))


def jax_masks(key, w, n=N):
    """The masks JAX's step draws from `key` (models/training.py:88-91)."""
    k1, k2 = jax.random.split(key)
    return (np.array(4 * jax.random.randint(k1, (n,), 0, w // 4 + 1)),
            np.array(4 * jax.random.randint(k2, (n,), 0, w // 4 + 1)))


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


@pytest.fixture(scope="module")
def j_state():
    return {(w, fc): j_training.init_state(jax.random.PRNGKey(w), w, fc,
                                           total_iters=TOTAL)
            for w, fc in CONFIGS}


def _j_loss_grads(params, a, l, t, wa, hl, *, w, fc):
    """The loss of JAX's step (models/training.py:93-112) and its
    gradients."""
    n = t.shape[0]
    above = a.astype(jnp.float32) - MEAN
    left = l.astype(jnp.float32) - MEAN
    cols = jnp.arange(3 * w).reshape(1, 1, -1, 1)
    rows = jnp.arange(2 * w).reshape(1, -1, 1, 1)
    above = jnp.where(cols >= 3 * w - wa.reshape(-1, 1, 1, 1), 0.0, above)
    left = jnp.where(rows >= 2 * w - hl.reshape(-1, 1, 1, 1), 0.0, left)
    targets = t.astype(jnp.float32) - MEAN
    inputs = (jnp.concatenate([above.reshape(n, -1), left.reshape(n, -1)], 1)
              if fc else (above, left))

    def loss_fn(p):
        return j_losses.total_loss(p, targets, j_pnn.forward(p, inputs, w, fc),
                                   COEFFS["coeff_l2"], COEFFS["coeff_grad"])

    return jax.value_and_grad(loss_fn, has_aux=True)(params)


j_loss_grads = jax.jit(_j_loss_grads, static_argnames=("w", "fc"))


# ----------------------------------------------------------------- losses ----

@pytest.mark.parametrize("coeffs", [(1.0, 0.0), (0.0, 1.0), (1.0, 0.5)],
                         ids=["l2", "grad", "both"])
def test_total_loss_and_terms_match_jax(coeffs):
    rng = np.random.default_rng(3)
    t = (rng.standard_normal((6, 8, 8, 1)) * 40).astype(np.float32)
    p = (rng.standard_normal((6, 8, 8, 1)) * 40).astype(np.float32)
    params, _ = t_zoo.load_frozen_params(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "artifacts", "frozen", "pnn_w8_refconv_single.npz"))
    j_loss, j_terms = j_losses.total_loss(params, jnp.asarray(t),
                                          jnp.asarray(p), *coeffs)
    t_loss, t_terms = t_losses.total_loss(
        t_zoo.params_from_numpy(params, "cpu"), torch.from_numpy(t),
        torch.from_numpy(p), *coeffs)
    assert set(t_terms) == set(j_terms)
    for k in j_terms:
        assert abs(float(t_terms[k]) - float(j_terms[k])) \
            <= 1e-6 * abs(float(j_terms[k])), k
    assert abs(float(t_loss) - float(j_loss)) <= 1e-6 * abs(float(j_loss))
    for fn in ("prediction_error_l2_norm", "prediction_error_gradient"):
        got = float(getattr(t_losses, fn)(torch.from_numpy(t),
                                          torch.from_numpy(p)))
        want = float(getattr(j_losses, fn)(jnp.asarray(t), jnp.asarray(p)))
        assert abs(got - want) <= 1e-6 * abs(want), fn


def test_weight_decay_exempts_biases():
    params = {"a": {"weights": torch.ones(3), "biases": torch.ones(5)},
              "weights_0": torch.full((2,), 2.0), "biases_0": torch.ones(7)}
    assert float(t_losses.weight_l2_norm(params)) == 0.5 * (3 + 8)


@pytest.mark.parametrize("coeffs,msg", [((-1.0, 1.0), "non-negative"),
                                        ((1.0, -0.5), "non-negative"),
                                        ((0.0, 0.0), "non-zero")])
def test_total_loss_argument_checks(coeffs, msg):
    t = torch.zeros((1, 4, 4, 1))
    with pytest.raises(ValueError, match=msg):
        t_losses.total_loss({"weights_0": torch.ones(1)}, t, t, *coeffs)


# --------------------------------------------------------------- training ----

@pytest.mark.parametrize("random", [False, True], ids=["fixed", "jax_drawn"])
@pytest.mark.parametrize("w,fc", CONFIGS, ids=IDS)
def test_loss_and_gradients_match_jax(j_state, w, fc, random):
    state = j_state[(w, fc)]
    a, l, t = batch(w, 1)
    if random:
        wa, hl = jax_masks(jax.random.PRNGKey(5), w)
    else:
        wa, hl = np.full(N, 4), np.full(N, 0)
    (j_loss, j_terms), j_g = j_loss_grads(
        state.params, a, l, t, jnp.asarray(wa), jnp.asarray(hl), w=w, fc=fc)
    tstate = t_training.state_from_numpy(jax_blob(state), "cpu")
    t_loss, t_terms, t_g = t_training.loss_and_grads(
        tstate.params, a, l, t, MEAN, torch.as_tensor(wa),
        torch.as_tensor(hl), width_target=w, is_fully_connected=fc, **COEFFS)
    assert abs(float(t_loss) - float(j_loss)) <= 1e-6 * abs(float(j_loss))
    for k in j_terms:
        assert abs(float(t_terms[k]) - float(j_terms[k])) \
            <= 1e-6 * abs(float(j_terms[k])), k
    jg = dict(flat(jax.device_get(j_g)))
    tg = dict(flat(t_zoo.params_to_numpy(t_g)))
    assert jg.keys() == tg.keys()
    for k in jg:
        scale = np.abs(jg[k]).max()
        assert scale > 0, k
        err = np.abs(tg[k] - jg[k]) / scale
        # A LeakyReLU input within float32 rounding of 0 can take the other
        # slope in one package: the gradients of the params feeding that
        # one unit then differ by up to 0.9 of its share.
        assert np.mean(err <= 1e-5) >= 0.98 and err.max() <= 5e-2, (
            k, np.mean(err <= 1e-5), err.max())


@pytest.mark.parametrize("w,fc", CONFIGS, ids=IDS)
def test_float64_reference_step(j_state, w, fc):
    """`loss_and_grads` on float64 params computes in float64 (the card's
    reference): float64 gradients, the loss within 1e-5 of the float32
    step's, each leaf within 5e-2 of its max |g| of the float32 one."""
    state = t_training.state_from_numpy(jax_blob(j_state[(w, fc)]), "cpu")
    a, l, t = batch(w, 2)
    wa, hl = t_training.draw_masks(torch.Generator().manual_seed(3), N, w)
    kw = dict(width_target=w, is_fully_connected=fc, **COEFFS)
    l32, _, g32 = t_training.loss_and_grads(state.params, a, l, t, MEAN, wa,
                                            hl, **kw)
    l64, terms, g64 = t_training.loss_and_grads(
        t_training.tree_map(torch.Tensor.double, state.params), a, l, t,
        MEAN, wa, hl, **kw)
    assert l64.dtype == torch.float64 and all(
        v.dtype == torch.float64 for v in terms.values())
    assert abs(float(l64) - float(l32)) <= 1e-5 * abs(float(l64))
    for path in t_training._paths(g64):
        x, y = t_training._get(g32, path), t_training._get(g64, path)
        assert y.dtype == torch.float64
        assert (x.double() - y).abs().max() <= 5e-2 * y.abs().max(), path


@pytest.mark.parametrize("count", [0, 3, 4, 5, 6, 7, 8, 1000])
def test_adam_update_on_identical_gradients_matches_optax(j_state, count):
    w, fc = 8, False
    state = j_state[(w, fc)]
    rng = np.random.default_rng(count)
    rand = lambda tree, s: jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32)
        * np.float32(10.0) ** rng.integers(-9, 1, x.shape).astype(np.float32)
        * s), tree)
    grads = rand(state.params, 1.0)
    adam, sched = j_training.make_optimizer(w, TOTAL).init(state.params)
    mu = rand(state.params, 1e-2)
    nu = jax.tree.map(lambda x: jnp.abs(x) * 1e-3, rand(state.params, 1.0))
    opt_state = (adam._replace(count=jnp.asarray(count, jnp.int32), mu=mu,
                               nu=nu),
                 sched._replace(count=jnp.asarray(count, jnp.int32)))
    updates, j_opt = j_training.make_optimizer(w, TOTAL).update(
        grads, opt_state, state.params)
    j_params = optax.apply_updates(state.params, updates)

    tstate = t_training.state_from_numpy(
        {"params": jax.device_get(state.params),
         "opt_state": jax.device_get(opt_state), "step": count}, "cpu")
    t_opt = t_training.adam_update(
        tstate.params, t_zoo.params_from_numpy(jax.device_get(grads), "cpu"),
        tstate.opt_state, w, TOTAL)
    assert t_opt[0].count == int(j_opt[0].count) == count + 1
    assert t_opt[1].count == int(j_opt[1].count) == count + 1
    for want, got in ((j_params, tstate.params), (j_opt[0].mu, t_opt[0].mu),
                      (j_opt[0].nu, t_opt[0].nu)):
        want = dict(flat(jax.device_get(want)))
        got = dict(flat(t_zoo.params_to_numpy(got)))
        for k in want:
            assert ulps(got[k], want[k]) <= 2, k


@pytest.mark.parametrize("total", [8, 100, 800_000])
@pytest.mark.parametrize("w", [8, 16])
def test_learning_rate_schedule_matches_optax_at_every_boundary(w, total):
    base = 1e-4 if w <= 8 else 4e-4
    want = optax.piecewise_constant_schedule(
        base, {total // 2: 0.1, 3 * total // 4: 0.1, 7 * total // 8: 0.1})
    got = t_training.learning_rate_schedule(w, total)
    for b in (total // 2, 3 * total // 4, 7 * total // 8):
        for count in (b - 1, b, b + 1):
            j = np.float32(want(jnp.asarray(count, jnp.int32)))
            assert got(count).dtype == np.float32
            assert got(count) == j, (b, count)
    assert got(0) == np.float32(base)
    assert got(total // 2 - 1) == np.float32(base)
    assert got(total // 2) < got(total // 2 - 1)


@pytest.fixture(scope="module")
def j_trajectories(j_state):
    """5 JAX steps per configuration, fixed masks and JAX-drawn ones:
    losses, the keys' masks, the batches."""
    out = {}
    for w, fc in CONFIGS:
        for random in (False, True):
            state = j_state[(w, fc)]
            losses, masks, batches = [], [], []
            for i in range(5):
                key = jax.random.PRNGKey(100 + i)
                b = batch(w, 10 + i)
                state, loss, _ = j_training.train_step(
                    state, key, *b, MEAN, jnp.array([4, 4]), width_target=w,
                    is_fully_connected=fc, random_masks=random,
                    total_iters=TOTAL, **COEFFS)
                losses.append(float(loss))
                masks.append(jax_masks(key, w))
                batches.append(b)
            out[(w, fc, random)] = (np.array(losses), masks, batches)
    return out


@pytest.mark.parametrize("random", [False, True], ids=["fixed", "jax_drawn"])
@pytest.mark.parametrize("w,fc", CONFIGS, ids=IDS)
def test_five_step_loss_trajectory_matches_jax(j_state, j_trajectories, w,
                                               fc, random):
    want, masks, batches = j_trajectories[(w, fc, random)]
    state = t_training.state_from_numpy(jax_blob(j_state[(w, fc)]), "cpu")
    got = []
    for b, m in zip(batches, masks):
        state, loss, terms = t_training.train_step(
            state, None, *b, MEAN, (4, 4), width_target=w,
            is_fully_connected=fc, random_masks=random, total_iters=TOTAL,
            example_masks=m if random else None, **COEFFS)
        got.append(float(loss))
        assert set(terms) == {"l2_norm_pred_error", "grad_error",
                              "weight_decay"}
    assert state.step == 5 and state.opt_state[0].count == 5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def stacked_batches(w, k, seed):
    bs = [batch(w, seed + i) for i in range(k)]
    return [np.stack([b[i] for b in bs]) for i in range(3)]


def state_arrays(state):
    blob = t_training.state_to_numpy(state)
    out = dict(flat(blob["params"], "params/"))
    out.update(flat(blob["opt_state"][0].mu, "mu/"))
    out.update(flat(blob["opt_state"][0].nu, "nu/"))
    return out


def assert_states_equal(a, b):
    assert a.step == b.step and a.opt_state[0].count == b.opt_state[0].count
    assert a.opt_state[1].count == b.opt_state[1].count
    x, y = state_arrays(a), state_arrays(b)
    assert x.keys() == y.keys()
    for k in x:
        assert np.array_equal(x[k].view(np.int32), y[k].view(np.int32)), k


KW8 = dict(width_target=8, is_fully_connected=False, random_masks=True,
           total_iters=TOTAL, **COEFFS)


def fresh_state(seed=0):
    return t_training.init_state(torch.Generator().manual_seed(seed), 8,
                                 False, device="cpu")


def test_train_chunk_equals_k_train_steps():
    a, l, t = stacked_batches(8, 3, 40)
    g1, g2 = (torch.Generator().manual_seed(1) for _ in range(2))
    s1, losses = t_training.train_chunk(fresh_state(), g1, a, l, t, MEAN,
                                        (0, 0), **KW8)
    s2 = fresh_state()
    step_losses = []
    for i in range(3):
        s2, loss, _ = t_training.train_step(s2, g2, a[i], l[i], t[i], MEAN,
                                            (0, 0), **KW8)
        step_losses.append(loss)
    assert torch.equal(losses, torch.stack(step_losses))
    assert_states_equal(s1, s2)


def test_resume_equals_uninterrupted_run(tmp_path):
    """Two chunks of 3 steps across LR boundary 4, random masks, with a
    checkpoint after the first: the restored run's second chunk equals
    the uninterrupted one bit for bit (params, moments, losses)."""
    a, l, t = stacked_batches(8, 6, 50)
    gen = torch.Generator().manual_seed(1)
    state, _ = t_training.train_chunk(fresh_state(), gen, a[:3], l[:3],
                                      t[:3], MEAN, (0, 0), **KW8)
    path = t_training.save_checkpoint(state, str(tmp_path), gen)
    assert os.path.basename(path) == "model_3.ckpt.pkl"
    whole, whole_losses = t_training.train_chunk(state, gen, a[3:], l[3:],
                                                 t[3:], MEAN, (0, 0), **KW8)
    gen2 = torch.Generator().manual_seed(99)
    restored = t_training.restore_checkpoint(path, 8, device="cpu",
                                             generator=gen2)
    assert t_training.find_latest_checkpoint(str(tmp_path)) == (path, 3)
    resumed, resumed_losses = t_training.train_chunk(
        restored, gen2, a[3:], l[3:], t[3:], MEAN, (0, 0), **KW8)
    assert torch.equal(whole_losses, resumed_losses)
    assert_states_equal(whole, resumed)
    # The schedule read the persisted count: step 4 ran at the scaled LR.
    assert t_training.learning_rate_schedule(8, TOTAL)(3) \
        > t_training.learning_rate_schedule(8, TOTAL)(4)


def test_checkpoint_round_trip_is_exact(tmp_path):
    a, l, t = stacked_batches(8, 2, 60)
    state, _ = t_training.train_chunk(fresh_state(3), None, a, l, t, MEAN,
                                      (4, 8), **dict(KW8, random_masks=False))
    path = t_training.save_checkpoint(state, str(tmp_path))
    assert_states_equal(t_training.restore_checkpoint(path, 8, device="cpu"),
                        state)
    blob = t_training.read_checkpoint(path)
    assert sorted(blob) == ["opt_state", "params", "step"]
    assert blob["opt_state"][0].count.dtype == np.int32
    # The params are in the JAX layout: JAX's forward runs on them.
    x = np.random.default_rng(0).standard_normal((2, 8, 24, 1)).astype(
        np.float32)
    y = np.random.default_rng(1).standard_normal((2, 16, 8, 1)).astype(
        np.float32)
    want = np.asarray(j_pnn.forward(blob["params"], (x, y), 8, False))
    with torch.no_grad():
        got = t_pnn.forward(state.params, (torch.from_numpy(x),
                                           torch.from_numpy(y)), 8, False)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_find_latest_checkpoint(tmp_path):
    assert t_training.find_latest_checkpoint(str(tmp_path / "none")) \
        == (None, 0)
    for step in (10, 200, 30):
        (tmp_path / f"model_{step}.ckpt.pkl").write_bytes(b"")
    (tmp_path / "model_999.other").write_bytes(b"")
    assert t_training.find_latest_checkpoint(str(tmp_path)) == (
        str(tmp_path / "model_200.ckpt.pkl"), 200)


@pytest.mark.parametrize("w,fc", CONFIGS, ids=IDS)
def test_jax_checkpoint_resumes_in_the_port(j_state, w, fc, tmp_path):
    """A JAX-written checkpoint after one JAX step, restored by the port
    and stepped once more, against JAX's own next step: loss within 1e-6
    relative, moments within 1e-5 of each leaf's max, params within 2 lr
    (the near-zero-gradient entries), counts equal."""
    kw = dict(width_target=w, is_fully_connected=fc, random_masks=False,
              total_iters=TOTAL, **COEFFS)
    state, _, _ = j_training.train_step(j_state[(w, fc)],
                                        jax.random.PRNGKey(0), *batch(w, 70),
                                        MEAN, jnp.array([0, 4]), **kw)
    path = j_training.save_checkpoint(state, str(tmp_path))
    b = batch(w, 71)
    j_next, j_loss, _ = j_training.train_step(
        state, jax.random.PRNGKey(1), *b, MEAN, jnp.array([0, 4]), **kw)
    t_state = t_training.restore_checkpoint(path, w, device="cpu")
    assert t_state.step == 1 and t_state.opt_state[0].count == 1
    t_next, t_loss, _ = t_training.train_step(t_state, None, *b, MEAN,
                                              (0, 4), **kw)
    assert abs(float(t_loss) - float(j_loss)) <= 1e-6 * abs(float(j_loss))
    assert t_next.step == int(j_next.step) == 2
    lr = float(t_training.learning_rate_schedule(w, TOTAL)(1))
    got = t_training.state_to_numpy(t_next)
    for want_tree, got_tree, tol in (
            (j_next.opt_state[0].mu, got["opt_state"][0].mu, "rel"),
            (j_next.opt_state[0].nu, got["opt_state"][0].nu, "rel"),
            (j_next.params, got["params"], "lr")):
        want = dict(flat(jax.device_get(want_tree)))
        have = dict(flat(got_tree))
        for k in want:
            err = np.abs(have[k] - want[k]).max()
            bound = (1e-5 * np.abs(want[k]).max() if tol == "rel"
                     else 2 * lr + 1e-6 * np.abs(want[k]).max())
            assert err <= bound, (k, err, bound)


def test_restore_refuses_foreign_globals(tmp_path):
    path = tmp_path / "model_1.ckpt.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": {}, "opt_state": (os.getcwd,), "step": 1}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd|getcwd"):
        t_training.read_checkpoint(str(path))


# ------------------------------------------------------------- init, masks ----

def expected_std(path, shape):
    """The JAX package's init constants (models/pnn.py:91-175)."""
    name = path.split("/")
    if name[0] == "fully_connected":
        return [0.01, 0.029, 0.029, 0.01][int(name[1].split("_")[1])]
    leaf_scope = name[-2]
    if leaf_scope == "channelwise_fully_connected_merger":
        return 1 / math.sqrt(shape[1])
    k, c_in = shape[0], shape[2] if leaf_scope.startswith("convolution") \
        else shape[3]
    first = leaf_scope == "convolution_0"
    last = leaf_scope.startswith("transpose") and shape[2] == 1
    return 0.01 if first or last else 1 / math.sqrt(c_in * k * k)


@pytest.mark.parametrize("w,fc", [(8, True), (8, False), (16, False)],
                         ids=["fc_w8", "conv_w8", "conv_w16"])
def test_init_params_match_jax_layout_and_constants(w, fc):
    got = dict(flat(t_pnn.init_params(torch.Generator().manual_seed(0), w,
                                      fc)))
    want = dict(flat(jax.device_get(j_pnn.init_params(
        jax.random.PRNGKey(0), w, fc))))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        if k.split("/")[-1].startswith("biases"):
            assert not got[k].any(), k
            continue
        sd = expected_std(k, want[k].shape)
        assert abs(got[k].std() / sd - 1) <= 0.05, (k, got[k].std(), sd)
        assert abs(want[k].std() / sd - 1) <= 0.05, (k, want[k].std(), sd)
    again = dict(flat(t_pnn.init_params(torch.Generator().manual_seed(0), w,
                                        fc)))
    assert all(np.array_equal(again[k], got[k]) for k in got)


def test_mask_draw_support_and_seed():
    for w in (4, 8, 16, 32, 64):
        wa, hl = t_training.draw_masks(torch.Generator().manual_seed(1),
                                       4000, w)
        for m in (wa, hl):
            assert set(m.tolist()) == set(range(0, w + 1, 4)), w
        wa2, hl2 = t_training.draw_masks(torch.Generator().manual_seed(1),
                                         4000, w)
        assert torch.equal(wa, wa2) and torch.equal(hl, hl2)
        assert not torch.equal(wa, hl)


# -------------------------------------------------- kernels and autograd ----

def test_float_kernel_wrappers_refuse_autograd():
    x = torch.randn(3, 20, requires_grad=True)
    ws = [torch.randn(20, 8), torch.randn(8, 8), torch.randn(8, 8),
          torch.randn(8, 4)]
    bs = [torch.zeros(8), torch.zeros(8), torch.zeros(8), torch.zeros(4)]
    with pytest.raises(RuntimeError, match="no backward"):
        fc_forward.fc_forward(x, ws, bs)
    with pytest.raises(RuntimeError, match="no backward"):
        fc_forward.fc_forward(x.detach(), ws[:3] + [ws[3].requires_grad_()],
                              bs, impl="plain")
    with torch.no_grad():
        fc_forward.fc_forward(x, ws, bs)
    xm = torch.randn(2, 5, 8)
    wm = torch.randn(5, 3, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        merger.merger_forward(xm, wm, torch.zeros(3, 8))
    with pytest.raises(RuntimeError, match="no backward"):
        merger.merger_forward(xm.requires_grad_(), wm.detach(),
                              torch.zeros(3, 8), act=True)
    assert merger.merger_forward(xm.detach(), wm.detach(),
                                 torch.zeros(3, 8)).shape == (2, 3, 8)


@pytest.mark.parametrize("fc", [True, False], ids=["fc_w8", "conv_w8"])
def test_serving_forward_after_a_step_sees_the_new_weights(fc):
    state = t_training.init_state(torch.Generator().manual_seed(2), 8, fc,
                                  device="cpu")
    rng = np.random.default_rng(0)
    x = (torch.from_numpy(rng.standard_normal((4, 320)).astype(np.float32))
         if fc else tuple(torch.from_numpy(rng.standard_normal(s).astype(
             np.float32)) for s in ((4, 8, 24, 1), (4, 16, 8, 1))))
    before = t_pnn.forward(state.params, x, 8, fc).clone()
    state, _, _ = t_training.train_step(
        state, None, *batch(8, 90, 4), MEAN, (0, 0), width_target=8,
        is_fully_connected=fc, random_masks=False, **COEFFS)
    after = t_pnn.forward(state.params, x, 8, fc)
    assert not torch.equal(before, after)
    with torch.no_grad():
        assert torch.equal(after, t_pnn.forward_train(state.params, x, 8, fc))


def test_train_step_gives_the_flags_back():
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.backends.cudnn.enabled)
    old = flags()
    try:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.enabled) = (True, True, True)
        inside = []
        with t_training.exact_steps():
            inside.append(flags())
        assert inside == [(False, False, False)]
        assert flags() == (True, True, True)
        with pytest.raises(ValueError):
            t_training.train_step(fresh_state(), None, *batch(8, 1, 2), MEAN,
                                  (0, 0), width_target=8,
                                  is_fully_connected=False,
                                  random_masks=False, coeff_l2=0.0,
                                  coeff_grad=0.0)
        assert flags() == (True, True, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled) = old
