"""PyTorch/CUDA port of the context-adaptive neural-network intra codec.

A second package beside the JAX package
`context_adaptive_neural_network_based_prediction_tpu`, which stays the
reference: the port imports `torch` and numpy and none of the JAX package.
Its subpackages carry the same names (`codec/`, `data/`, `evaluation/`,
`models/`, `ops/`, `parallel/`, `utils/`, `cli/`).  Ported: the wavefront
encoder `parallel.wavefront2.encode_frame_wavefront2` (CTB 32 and 64, one
frame or a batch; regular, `switch` and `substitution` policies; Annex-B
output), the uniform-grid v1 encoder `parallel.wavefront`, the decoder,
the quantize path of float PNNs (`codec.nn_intra.PnnBundle.quantize`,
`models.zoo.load_codec_bundle`), with the fused unit trial
and the quantized PNN's integer merger as hand-written CUDA kernels
(`ops/csrc/unit_trial.cu`, `merger_int.cu`); and the float PNN prediction
path `evaluation.prediction_comparison.compare_on_channels`, with the FC
layers and the float merger as CUDA kernels (`ops/csrc/fc_forward.cu`,
`merger.cu`); and PNN training (`models.training`, `data.pipeline`,
`cli.train_pnn` / `export_pnn` / `create_training_set`) with IPFCN-S
(`models.ipfcn`).  Entry points take a `device` argument that defaults to
"cuda"; the CPU runs only the plain PyTorch versions.
"""

__version__ = "0.1.0"
