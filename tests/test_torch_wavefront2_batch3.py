"""The 3-frame 128x128 batches of `test_torch_wavefront2_batch.py` (the
natural crop and two seeded frames) against single-frame port encodes,
under every configuration of that file, and the check that the switch
batches code PNNS PUs; a file of its own, so that it runs beside the
2-frame half.  Helpers and fixtures come from that file.
"""

import pytest

from test_torch_wavefront2_batch import (BATCHES, CONFIGS,  # noqa: F401
                                         check_batched_frame, encodes,
                                         few_threads, port_bundle)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("name,frame", [("b3_128x128", f) for f in range(3)])
def test_batched_frame_equals_single_frame(encodes, config, name, frame):
    check_batched_frame(encodes, config, name, frame)


def test_switch_batches_code_pnns_pus(encodes):
    """The random bundle's PNNS mode wins somewhere in the switch batches,
    so the per-(slot, frame) PNN path decides part of what is compared.
    (Under substitution its mode-18 prediction wins nowhere in these
    frames; `tests/test_torch_decoder.py` decodes a batched substitution
    stream of the frozen zoo that codes PNN PUs.)"""
    found = [r[3] for name in BATCHES for r in encodes["switch", name][1]]
    assert sum(found) > 0, found
