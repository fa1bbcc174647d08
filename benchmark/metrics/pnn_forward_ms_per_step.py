"""PNN forward: card milliseconds (CUDA events) of one step's quantized
PNN forwards, run by the benchmark at a launch's size (64 w4, 16 w8,
4 w16 and 1 w32 calls over every slot of the batch)."""


def read(rec):
    s = rec["spans"].get("pnn_forward_s_per_step")
    return None if s is None else s * 1e3
