"""The port's DP x TP sharded training (`parallel/sharded_training.py`)
over Gloo ranks on the CPU, the training CLI's `--dp/--tp`, and the
multi-rank dry run (`parallel/dryrun.py`).

* `param_specs` equals the partition specs the JAX package's
  `shard_params` gives every leaf at tp = 2 (FC w8, conv w4 and w16).
* A 2 x 2 (data x model) chunk of 3 steps from one state and mask
  generator against the port's single-device `training.train_chunk`
  (FC w4, conv w8; batch 8 and 32): the losses within 1e-5 relative at
  every step and the Adam moments within 1e-5 of each leaf's max
  |value|.  The parameters within 1e-5 of the leaf's max |value| at all
  but 1e-4 of a leaf's entries, and those within 2 K lr (K updates of at
  most lr each apart): where a gradient is of the order of Adam's
  eps = 1e-8, the update mu_hat / (sqrt(nu_hat) + eps) turns a float32
  rounding of the gradient (the shards sum in another order) into a
  different update (a few entries in a million here).
* The same chunks run in float64 on both sides: the losses, the
  parameters and the Adam moments within 1e-5 of each leaf's max |value|
  at every entry (float64 sums in either order leave Adam nothing to
  amplify).
* With fixed masks, the sharded loss equals the JAX package's
  `training.train_step(random_masks=False)` from the same state within
  1e-5 relative.
* A sharded state gathered and checkpointed restores single-device bit
  for bit; a single-device state resumes sharded.
* `train_pnn --dp 2` under 2 ranks and `--dp 2 --tp 2` under 4 write
  their snapshots from rank 0 and resume from each other's.
* `dryrun_multichip(2, "cpu")`.
"""

import math
import multiprocessing
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn as j_pnn, training as j_training)
from context_adaptive_neural_network_based_prediction_tpu.parallel import (
    mesh as j_mesh, sharded_training as j_sharded)
from context_adaptive_neural_network_based_prediction_tpu_torch.cli import (
    train_pnn as t_train)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    training as t_training, zoo as t_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    dryrun as t_dryrun, mesh as t_mesh, sharded_training as t_sharded)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = 86.8568
K = 3
CASES = {"fc_w4": (4, True, 8), "conv_w8": (8, False, 32)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def stacks(w, n, k=K, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (k, n, w, 3 * w, 1), dtype=np.uint8),
            rng.integers(0, 256, (k, n, 2 * w, w, 1), dtype=np.uint8),
            rng.integers(0, 256, (k, n, w, w, 1), dtype=np.uint8))


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("w,fc", [(8, True), (4, False), (16, False)],
                         ids=["fc_w8", "conv_w4", "conv_w16"])
def test_param_specs_equal_jax(w, fc):
    m = j_mesh.make_mesh({"data": 1, "model": 2}, jax.devices()[:2])
    params = j_pnn.init_params(jax.random.PRNGKey(0), w, fc)
    def specs_of(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from specs_of(tree[k], f"{prefix}/{k}")
        else:
            yield prefix, tuple(tree)

    sharded = j_sharded.shard_params(params, m, fc)
    want = dict(specs_of(jax.tree_util.tree_map(
        lambda a: tuple(a.sharding.spec), sharded)))
    got = dict(specs_of(t_sharded.param_specs(jax.device_get(params), 2,
                                              fc)))
    assert got == want
    assert any(any(a is not None for a in s) for s in got.values())


def run_chunks(dtype):
    """Per case: (sharded losses, gathered state) of a 2 x 2 group, and
    the single-device chunk's (losses, state), from one state (in `dtype`)
    and mask generator."""
    out = {}
    for name, (w, fc, n) in CASES.items():
        state = t_training.init_state(torch.Generator().manual_seed(0), w,
                                      fc, device="cpu")
        blob = t_training.state_to_numpy(state)
        state = t_training.cast_state(state, dtype)
        gen = torch.Generator().manual_seed(1)
        batches = stacks(w, n)
        got = t_mesh.spawn_ranks(
            t_sharded.chunk_from_state, 4, device="cpu",
            args=({"data": 2, "model": 2}, w, fc, blob,
                  gen.get_state().numpy(), *batches, MEAN),
            kwargs=dict(device="cpu", float64=dtype == torch.float64),
            timeout=300)
        ref_state, ref_losses = t_training.train_chunk(
            state, gen, *batches, MEAN, (0, 0), width_target=w,
            is_fully_connected=fc, coeff_l2=1.0, coeff_grad=0.0,
            random_masks=True)
        out[name] = (got, ref_losses.numpy(),
                     t_training.state_to_numpy(ref_state))
    assert multiprocessing.active_children() == []
    return out


@pytest.fixture(scope="module")
def chunk_runs():
    return run_chunks(torch.float32)


@pytest.fixture(scope="module")
def chunk_runs64():
    return run_chunks(torch.float64)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_tp_chunk_losses_and_moments(chunk_runs, name):
    got, ref_losses, ref = chunk_runs[name]
    losses, state = got[0]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=0)
    for r in got[1:]:          # every rank reports the same run
        np.testing.assert_array_equal(r[0], losses)
    adam, ref_adam = state["opt_state"][0], ref["opt_state"][0]
    assert int(adam.count) == int(ref_adam.count) == K
    assert state["step"] == ref["step"] == K
    for tree, want in ((adam.mu, ref_adam.mu), (adam.nu, ref_adam.nu)):
        for (path, a), (_, b) in zip(leaves(tree), leaves(want)):
            assert a.shape == b.shape, path
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), path


@pytest.mark.parametrize("name", list(CASES))
def test_dp_tp_chunk_parameters(chunk_runs, name):
    w = CASES[name][0]
    got, _, ref = chunk_runs[name]
    lr = float(t_training.learning_rate_schedule(w)(0))
    for (path, a), (_, b) in zip(leaves(got[0][1]["params"]),
                                 leaves(ref["params"])):
        assert a.shape == b.shape, path
        d = np.abs(a - b)
        off = int((d > 1e-5 * np.abs(b).max()).sum())
        assert off <= math.ceil(1e-4 * d.size), (path, off, d.size)
        assert d.max() <= 2 * K * lr, path


@pytest.mark.parametrize("name", list(CASES))
def test_dp_tp_chunk_float64_state(chunk_runs64, name):
    """In float64 the whole state after K sharded steps (parameters and
    both moments, every entry) is within 1e-5 of each leaf's max |value|
    of the single-device chunk's."""
    got, ref_losses, ref = chunk_runs64[name]
    losses, state = got[0]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=0)
    adam, ref_adam = state["opt_state"][0], ref["opt_state"][0]
    assert int(adam.count) == int(ref_adam.count) == K
    for tree, want in ((state["params"], ref["params"]),
                       (adam.mu, ref_adam.mu), (adam.nu, ref_adam.nu)):
        for (path, a), (_, b) in zip(leaves(tree), leaves(want)):
            assert a.dtype == b.dtype == np.float64, path
            assert a.shape == b.shape, path
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), path


def test_fixed_mask_sharded_loss_equals_jax():
    """One 2 x 2 step with masks (4, 8) for every example from the JAX
    package's initial state: the loss equals its `train_step`'s."""
    w, fc, n = 8, False, 8
    j_state = j_training.init_state(jax.random.PRNGKey(3), w, fc)
    a, l, t = stacks(w, n, k=1, seed=5)
    _, j_loss, _ = j_training.train_step(
        j_state, jax.random.PRNGKey(0), a[0], l[0], t[0], MEAN,
        jnp.array([4, 8]), width_target=w, is_fully_connected=fc,
        coeff_l2=1.0, coeff_grad=0.5, random_masks=False)
    blob = t_training.state_to_numpy(t_training.state_from_numpy(
        {"params": jax.device_get(j_state.params),
         "opt_state": jax.device_get(j_state.opt_state),
         "step": int(j_state.step)}, "cpu"))
    got = t_mesh.spawn_ranks(
        t_sharded.chunk_from_state, 4, device="cpu",
        args=({"data": 2, "model": 2}, w, fc, blob,
              torch.Generator().get_state().numpy(), a, l, t, MEAN),
        kwargs=dict(device="cpu", masks=(4, 8), coeff_grad=0.5),
        timeout=300)
    assert abs(float(got[0][0][0]) - float(j_loss)) \
        <= 1e-5 * abs(float(j_loss))


def test_sharded_checkpoint_resumes_single_device(chunk_runs, tmp_path):
    """The gathered state, checkpointed as rank 0 writes it, restores on
    one device bit for bit (params, moments, counts, step, generator)."""
    state = chunk_runs["fc_w4"][0][0][1]
    gen = torch.Generator().manual_seed(9)
    path = t_training.save_checkpoint(
        t_training.state_from_numpy(state, "cpu"), str(tmp_path), gen)
    assert os.path.basename(path) == f"model_{K}.ckpt.pkl"
    back_gen = torch.Generator()
    back = t_training.state_to_numpy(t_training.restore_checkpoint(
        path, 4, device="cpu", generator=back_gen))
    assert torch.equal(back_gen.get_state(), gen.get_state())
    assert back["step"] == state["step"]
    for tree in ("params",):
        for (p, a), (_, b) in zip(leaves(back[tree]), leaves(state[tree])):
            assert np.array_equal(a, b) and a.dtype == b.dtype, p
    for x, y in zip(back["opt_state"], state["opt_state"]):
        assert int(x.count) == int(y.count)
    for name in ("mu", "nu"):
        for (p, a), (_, b) in zip(
                leaves(getattr(back["opt_state"][0], name)),
                leaves(getattr(state["opt_state"][0], name))):
            assert np.array_equal(a, b), p


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    """A w4 triplet shard made by the port's shard builder."""
    from context_adaptive_neural_network_based_prediction_tpu_torch.data \
        import datasets as t_datasets
    import PIL.Image

    root = tmp_path_factory.mktemp("sharded_cli")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        p = str(root / f"img{i}.png")
        PIL.Image.fromarray(rng.integers(0, 256, (330, 340, 3),
                                         dtype=np.uint8)).save(p)
        paths.append(p)
    out = str(root / "w4")
    t_datasets.create_training_shards(paths, out, width_target=4,
                                      nb_shards=1, triplets_per_image=8,
                                      images_per_file=2, device="cpu")
    return out


def test_train_pnn_cli_sharded_and_resumed(shard_dir, tmp_path, capfd):
    """`--dp 2` under 2 ranks writes model_2 from rank 0; one device
    resumes it to 3; `--dp 2 --tp 2` under 4 ranks resumes that to 4."""
    root = str(tmp_path / "r")
    argv = ["4", "--shards", shard_dir, "--mean", "90", "--results-root",
            root, "--batch-size", "4", "--chunk", "2", "--snapshot-every",
            "2", "--device", "cpu"]
    t_mesh.spawn_ranks(t_train.main, 2, device="cpu",
                       args=(argv + ["--iters", "2", "--dp", "2"],),
                       timeout=300)
    d = t_zoo.model_directory(root, 4, True, False, "luminance", 1.0, 0.0,
                              None)
    assert sorted(os.listdir(d)) == ["model_2.ckpt.pkl"]
    assert capfd.readouterr().out.count("snapshot ") == 1
    t_train.main(argv + ["--iters", "3"])
    assert "resumed from" in capfd.readouterr().out
    t_mesh.spawn_ranks(t_train.main, 4, device="cpu",
                       args=(argv + ["--iters", "4", "--dp", "2", "--tp",
                                     "2"],), timeout=300)
    out = capfd.readouterr().out
    assert "(step 3)" in out and "step 4: loss" in out
    assert t_training.find_latest_checkpoint(d)[1] == 4
    blob = t_training.read_checkpoint(os.path.join(d, "model_4.ckpt.pkl"))
    assert blob["params"]["fully_connected"]["weights_1"].shape \
        == (1200, 1200)
    assert all(np.isfinite(a).all() for _, a in leaves(blob["params"]))
    assert multiprocessing.active_children() == []


def test_dryrun_multichip_two_cpu_ranks(capfd):
    t_dryrun.dryrun_multichip(2, "cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip(2, cpu): ok" in out and "bit-exact" in out
    assert multiprocessing.active_children() == []
