"""The benchmark of the PyTorch/CUDA port: run `benchmark/run.py`; see
`benchmark/README.md` for how cells, configurations, traffic mixes and
per-layer metrics are found by name."""
