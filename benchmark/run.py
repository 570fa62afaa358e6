"""Run one cell of the port's benchmark once, on the card, and print its
result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Without a
CUDA card (or with fewer than the cell asks for) the run prints why on
standard error and exits 2; without the program beside it, 4; if JAX or the
JAX package were loaded, 3.  See ``benchmark/README.md``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import device as dev
    from benchmark.harness import session
    from benchmark.harness.spec import Spec

    dev.keep_caches_in(ROOT)
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    try:
        dev.require_cards(int(cell["chips"]))
    except dev.NoCard as e:
        print(e, file=sys.stderr)
        return 2
    try:
        import taichi_nerfs_torch  # noqa: F401
    except ImportError as e:
        print(f"the program (taichi_nerfs_torch) is not beside the benchmark:"
              f" {e}", file=sys.stderr)
        return 4
    result = session.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START, spec)
    session.forbidden_or_exit()
    sys.stdout.flush()
    print(session.check_lines(result), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
