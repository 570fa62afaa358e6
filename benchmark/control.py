"""The control of a cell's comparison: the plain reference put in the
program's place, computed a precision lower than the configuration states
(every fp32 product's operands rounded to TF32), against the reference in
full precision, at the cell's own inputs and sizes.  It has to come out
not correct; its readings set the upper end of each limit.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

Prints one JSON line a seed: the numbers compared and the cell's limits.
The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(spec, cell_name: str, seed: int, device: str) -> dict:
    """The control's numbers for ``seed``: ``name -> value`` (for a view
    cell the worst frame's)."""
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    system = spec.system(config["family"])
    if traffic["kind"] == "train":
        sess = system.TrainSession(config, traffic, seed, device)
        sess.release()
        return sess.control()
    sess = system.ViewSession(config, traffic, seed, device)
    sess.release()
    return {k: max(v.values()) for k, v in sess.control().items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness.spec import Spec

    spec = Spec(ROOT)
    limits = spec.traffic(spec.cell(args.workload)["traffic"])["limits"]
    for s in args.seeds.split(","):
        t = time.perf_counter()
        nums = control_numbers(spec, args.workload, int(s), "cuda")
        fails = [k for k, v in nums.items() if v > float(limits[k])]
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "control": nums, "limits": limits,
                          "fails": fails,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
