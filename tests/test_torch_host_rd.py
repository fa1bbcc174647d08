"""The port's rate-distortion entry points and the host encoder's float
fallback against the JAX package, live on the CPU.

* `evaluation/performance.compute_rate_psnr` over QP 22 / 27 / 32 / 37,
  `regular` and `switch` (the quantized zoo), the rate from the Annex-B
  stream and the check through the HM-syntax decoder: rates and PSNRs
  equal to the JAX package's; `bd_rate_low_high_full` of switch against
  regular equal (exact float64 arithmetic on equal inputs, compared to
  1e-9); `compute_or_load_rates_psnrs` caches and reloads;
  `utils/metrics.compute_bjontegaard` equal on seeded curves.
* The float fallback: a bundle of the float models only
  (`artifacts/frozen/manifest_trained.txt`), `switch` at QP 27 (singles,
  conv) and 37 (pairs, FC at widths 4 / 8).  Every float forward of the
  port's encode is held against the JAX package's forward on the same
  context: within 1e-4 of max |JAX| (the float path's tolerance, as
  PERF.md section 2 states it), and the rounded pixels equal except where
  the JAX value lies within that tolerance of a .5 tie.  The pixels in
  that band and the pixels that rounded the other way are counted.
  Where no pixel rounded the other way, the stream, reconstruction and
  mode map equal the JAX package's.  The port's own decode of its stream
  is exact either way.
"""

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    encoder as j_encoder, nn_intra as j_nn_intra)
from context_adaptive_neural_network_based_prediction_tpu.evaluation import (
    performance as j_performance)
from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn as j_pnn, zoo as j_zoo)
from context_adaptive_neural_network_based_prediction_tpu.utils import (
    metrics as j_metrics)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    decoder as t_decoder, encoder as t_encoder, nn_intra as t_nn_intra)
from context_adaptive_neural_network_based_prediction_tpu_torch.evaluation \
    import host_cases, performance as t_performance
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    pnn as t_pnn, zoo as t_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.utils import (
    metrics as t_metrics)

from test_torch_host_encoder import (assert_same_encode, jax_zoo,
                                     mean_training, natural64, port_zoo)

QPS = (22, 27, 32, 37)
FLOAT_TOL = 1e-4         # of max |JAX prediction|, per forward


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def sweeps():
    frame = natural64()
    zoos = {"port": port_zoo(), "jax": jax_zoo()}
    out = {}
    for policy in ("regular", "switch"):
        j_kw = t_kw = {}
        if policy == "switch":
            j_kw = dict(pnn=j_nn_intra.PnnPredictor(zoos["jax"]))
            t_kw = dict(pnn=zoos["port"])
        out["jax", policy] = [j_performance.compute_rate_psnr(
            frame, qp, policy=policy, use_hm_container=True, **j_kw)
            for qp in QPS]
        out["port", policy] = [t_performance.compute_rate_psnr(
            frame, qp, policy=policy, use_hm_container=True, device="cpu",
            **t_kw) for qp in QPS]
    return out


@pytest.mark.parametrize("policy", ["regular", "switch"])
def test_rate_psnr_matches_jax(sweeps, policy):
    got, want = sweeps["port", policy], sweeps["jax", policy]
    assert [(p.qp, p.rate_bpp, p.psnr_db) for p in got] == [
        (p.qp, p.rate_bpp, p.psnr_db) for p in want]
    assert all(p.encode_time_s > 0 and p.decode_time_s > 0 for p in got)


def test_bd_rate_matches_jax(sweeps):
    got = t_performance.bd_rate_low_high_full(sweeps["port", "regular"],
                                              sweeps["port", "switch"])
    want = j_performance.bd_rate_low_high_full(sweeps["jax", "regular"],
                                               sweeps["jax", "switch"])
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k


def test_rate_psnr_cache_round_trip(sweeps, tmp_path):
    path = str(tmp_path / "rd" / "points.pkl")
    frame = natural64()[:32, :32].copy()
    first = t_performance.compute_or_load_rates_psnrs(
        frame, (27, 37), path_to_cache=path, device="cpu")
    again = t_performance.compute_or_load_rates_psnrs(
        frame, (27, 37), path_to_cache=path, device="cpu")
    assert first == again
    assert [p.qp for p in again] == [27, 37]


@pytest.mark.parametrize("seed", range(4))
def test_bjontegaard_matches_jax(seed):
    rng = np.random.default_rng(seed)
    r0 = np.sort(rng.uniform(0.1, 3.0, 6))
    r1 = r0 * rng.uniform(0.8, 1.1, 6)
    p0 = np.sort(rng.uniform(28, 44, 6))
    p1 = p0 + rng.uniform(-0.3, 0.3, 6)
    assert (t_metrics.compute_bjontegaard(r0, p0, r1, p1)
            == j_metrics.compute_bjontegaard(r0, p0, r1, p1))


# ----------------------------------------------------------- float path --

def jax_float_bundle():
    return j_zoo.load_codec_bundle(host_cases.MANIFEST_TRAINED,
                                   mean_training())


def port_float_bundle():
    return t_zoo.load_codec_bundle(host_cases.MANIFEST_TRAINED,
                                   mean_training())


@pytest.mark.parametrize("qp", [27, 37])
def test_float_fallback_matches_jax_within_tolerance(qp, monkeypatch):
    frame = natural64()
    j_bundle = jax_float_bundle()
    t_bundle = port_float_bundle()
    assert t_bundle.quantized is None
    j_params = j_bundle.params_for_qp(qp)
    mean = np.float32(mean_training())
    stats = {"forwards": 0, "near_ties": 0, "flips": 0, "worst": 0.0}
    plain = t_pnn.predict_uint8

    def checked(params, inputs, n, is_fc, mean_training):
        got = plain(params, inputs, n, is_fc, mean_training)
        raw = t_pnn.forward(params, inputs, n, is_fc).numpy()[0, :, :, 0]
        if is_fc:
            j_in = inputs.numpy()
        else:
            j_in = tuple(t.numpy() for t in inputs)
        want = np.asarray(j_pnn.forward(j_params[n], j_in, n, is_fc))[
            0, :, :, 0]
        scale = float(np.abs(want).max())
        err = float(np.abs(raw - want).max())
        stats["worst"] = max(stats["worst"], err / max(scale, 1e-30))
        assert err <= FLOAT_TOL * scale, (n, err, scale)
        px = np.clip(want + mean, 0.0, 255.0)
        tie = np.abs(px - np.floor(px) - 0.5) <= FLOAT_TOL * scale
        differ = got.numpy()[0] != np.round(px)
        assert not (differ & ~tie).any(), n
        stats["near_ties"] += int(tie.sum())
        stats["flips"] += int(differ.sum())
        stats["forwards"] += 1
        return got

    monkeypatch.setattr(t_pnn, "predict_uint8", checked)
    t_pred = t_nn_intra.PnnPredictor(t_bundle, device="cpu")
    got = t_encoder.encode_frame(frame, qp, policy="switch", pnn=t_pred,
                                 device="cpu")
    assert stats["forwards"] == sum(t_pred.float_forwards.values()) > 0
    assert sum(t_pred.forwards.values()) == 0
    if qp >= 32:
        assert t_pred.float_forwards["fc"] > 0
    else:
        assert t_pred.float_forwards["conv"] > 0
    print(f"QP {qp}: {stats['forwards']} float forwards, worst error "
          f"{stats['worst']:.3g} of max |JAX|, {stats['near_ties']} pixels "
          f"within the tolerance of a tie, {stats['flips']} rounded the "
          f"other way")
    monkeypatch.setattr(t_pnn, "predict_uint8", plain)
    dec = t_decoder.decode_frame(got.bitstream, pnn=t_bundle, device="cpu")
    np.testing.assert_array_equal(dec.reconstruction, got.reconstruction)
    if stats["flips"] == 0:
        want = j_encoder.encode_frame(frame, qp, policy="switch",
                                      pnn=j_nn_intra.PnnPredictor(j_bundle))
        assert_same_encode(got, want, f"float switch QP {qp}")


def test_float_only_predictor_supports_its_widths():
    t_pred = t_nn_intra.PnnPredictor(port_float_bundle(), device="cpu")
    assert all(t_pred.supports(n) for n in (4, 8, 16, 32, 64))
    assert not t_pred.supports(128)
