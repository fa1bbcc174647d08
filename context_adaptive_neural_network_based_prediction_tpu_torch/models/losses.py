"""PNN training losses, on tensors (differentiable).

The port of the JAX package's `models/losses.py`
(`prediction_error_l2_norm` :19, `prediction_error_gradient` :25,
`weight_l2_norm` :41, `total_loss` :51).  Targets and predictions are
(N, w, w, 1) float32, as `pnn.forward_train` gives them:

* l2-norm prediction error: mean over the batch of sqrt(sum((t - p)^2));
* gradient error: mean over the batch of the summed L1 norms of the
  finite-difference gradient mismatch along 4 directions (0, 45, 90 and
  135 degrees);
* weight decay: 5e-4 x the sum over weight tensors of ||W||^2 / 2.  Only
  leaves whose name starts with "weights" count, so biases are exempt;
  the sum of squares does not depend on the port's weight layouts.
"""

from __future__ import annotations

import torch

WEIGHT_DECAY_COEFF = 5.0e-4


def prediction_error_l2_norm(targets, predictions):
    """Mean over the batch of the l2 norm of the prediction residual."""
    sums = torch.sum((targets - predictions) ** 2, dim=(1, 2, 3))
    return torch.mean(torch.sqrt(sums))


def _diffs(t):
    return (
        t[:, :, 1:, :] - t[:, :, :-1, :],       # 0 deg: right - left
        t[:, :-1, 1:, :] - t[:, 1:, :-1, :],    # 45 deg: top right - bottom left
        t[:, :-1, :, :] - t[:, 1:, :, :],       # 90 deg: top - bottom
        t[:, 1:, 1:, :] - t[:, :-1, :-1, :],    # 135 deg: bottom right - top left
    )


def prediction_error_gradient(targets, predictions):
    """Mean summed L1 mismatch of finite-difference gradients in 4
    directions."""
    total = 0.0
    for dt, dp in zip(_diffs(targets), _diffs(predictions)):
        total = total + torch.sum(torch.abs(dp - dt), dim=(1, 2, 3))
    return torch.mean(total)


def _leaves(params, name=""):
    """(leaf name, tensor) of a nested param dict, keys in sorted order (the
    JAX package's tree order)."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _leaves(params[k], k)
    else:
        yield name, params


def weight_l2_norm(params):
    """Cumulated 0.5 ||W||^2 over every leaf whose name starts with
    "weights"."""
    total = 0.0
    for name, leaf in _leaves(params):
        if name.startswith("weights"):
            total = total + 0.5 * torch.sum(leaf ** 2)
    return total


def total_loss(params, targets, predictions, coeff_l2: float,
               coeff_grad: float, weight_l2=weight_l2_norm):
    """Scaled prediction losses + weight decay; returns (loss, dict of
    terms).  `weight_l2` computes the decay's sum of squares from
    `params` (sharded training sums it over the shards)."""
    if coeff_l2 < 0.0 or coeff_grad < 0.0:
        raise ValueError("loss coefficients must be non-negative.")
    if coeff_l2 == 0.0 and coeff_grad == 0.0:
        raise ValueError("at least one loss coefficient must be non-zero.")
    terms = {}
    loss = 0.0
    if coeff_l2:
        terms["l2_norm_pred_error"] = coeff_l2 * prediction_error_l2_norm(
            targets, predictions)
        loss = loss + terms["l2_norm_pred_error"]
    if coeff_grad:
        terms["grad_error"] = coeff_grad * prediction_error_gradient(
            targets, predictions)
        loss = loss + terms["grad_error"]
    terms["weight_decay"] = WEIGHT_DECAY_COEFF * weight_l2(params)
    loss = loss + terms["weight_decay"]
    return loss, terms
