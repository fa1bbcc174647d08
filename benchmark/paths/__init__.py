"""Encode paths of the port, one module each, named by a configuration's
`path` key.  A module gives `Cell(config, traffic, seed, device, root)`
(the system under test: `warm_up`, `call(k)` the timed call on batch k,
`inputs(k)`, `split_call(k)`, `layer_spans()`, `least_s(rates)`,
`steps`, `batch`, `release`) and `compare(config, traffic, pairs,
device)`, which holds (input frame, outputs) pairs against the plain
reference of `benchmark/reference/` and returns {name: {value, limit}}."""
