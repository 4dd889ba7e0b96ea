"""The readings that the comparison's limits are set from.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 --seconds <s>
        [--program port|control] [--out FILE]

For each seed, in one process: one run of the cell (set-up, a window of
``--seconds``, the comparison) with the measured program, or with the
control in its place (``control``: the plain reference in bfloat16, the
nearest lower precision of the configuration's float32). Prints one JSON
line per seed with the compared numbers (``checks``) and the requests made,
and a last line with the largest and smallest reading of each number. Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--program", default="port")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness
    from perfbench.run import _set_caches

    _set_caches()
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda", t, program=args.program)
        row = {"workload": cell.name, "program": args.program, "seed": seed,
               "attempted": res["attempted"], "failed": res["failed"],
               "checks": {k: v["value"] for k, v in res["checks"].items()},
               "seconds": time.perf_counter() - t}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    keys = rows[0]["checks"]
    summary = {"workload": cell.name, "program": args.program, "n": len(rows),
               "max": {k: max(r["checks"][k] for r in rows) for k in keys},
               "min": {k: min(r["checks"][k] for r in rows) for k in keys}}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "a") as f:
            for row in rows + [summary]:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
