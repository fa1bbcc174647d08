"""`parallel/mesh.rank_placement`: a rank's backend and card follow from
the device asked for (no ranks are started here)."""

import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu_torch.parallel \
    import mesh as t_mesh


@pytest.mark.parametrize("device,cards,rank,want", [
    ("cpu", 4, 1, ("gloo", "cpu")),
    ("cuda:0", 4, 1, ("gloo", "cuda:0")),
    ("cuda:2", 4, 0, ("gloo", "cuda:2")),
    ("cuda", 4, 2, ("nccl", "cuda:2")),
    ("cuda", 1, 1, ("gloo", "cuda:0")),
], ids=["cpu", "one_card", "card_2", "card_per_rank", "fewer_cards"])
def test_rank_placement(monkeypatch, device, cards, rank, want):
    """A rank's backend and card follow from the device asked for: NCCL
    only where every one of the 4 ranks has its own card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    backend, dev = t_mesh.rank_placement(device, rank, 4)
    assert (backend, str(dev)) == want
