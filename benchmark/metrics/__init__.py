"""Per-layer metric readers, one module each, named after the metric in
`BENCHMARK.json` (dots as underscores).  `read(rec)` takes the traced
run's record (`spans`: host and CUDA-event seconds the benchmark took
around its calls into a layer; `counters`: counts; `least_s`: the least
card seconds of a call's work from `benchmark/roofline.py`; `trace`: the
profiled call's summary, or None) and returns the metric's value, or
None where it finds nothing to read: the harness then leaves the metric
out of the result line."""
