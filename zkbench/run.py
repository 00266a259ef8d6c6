"""Run one cell of the benchmark once and print its result line.

    python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the card(s) the cell asks
for.  The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with --trace 1 `breakdown`, and
last `checks`: each number the reference compared, with its limit); the
same checks are the last lines of standard error.  Without a card, or with
a forbidden module loaded, or with no whole proof in the traced stretch, the
run prints no result and exits 2.  The SRS
and its window tables are cached in build/zkbench_params/ inside the
checkout, the kernels in build/torch_kernels/.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # load from one process with few threads: the host's tensor ops run on
    # one thread, so no idle OpenMP team competes with the prover's
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, ROOT)
    from zkbench import harness
    harness.use_params_dir()
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START)
    if out is None:
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
