"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints one JSON line last on stdout
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
also `breakdown`, and last `checks`: each number compared with the plain
reference beside its limit); the same numbers close stderr.  Exits 2
without a result when the machine lacks the cell's NVIDIA cards, 3 when
a module of the JAX stack or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    say = lambda msg: print(msg, file=sys.stderr, flush=True)
    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START, log=say)
    except harness.NoCard as e:
        say(f"no result: {e}")
        return 2
    bad = harness.forbidden_loaded()
    if bad:
        say("no result: modules of the JAX stack or the JAX package were "
            f"loaded: {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        say(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
