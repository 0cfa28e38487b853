"""The control of a cell's comparison: the plain reference computed in the
precision below the configuration's (``control_dtype``: fp8 convs for
bf16, TF32 for f32 with TF32 off), put in the program's place, on the
cell's own inputs at the cell's own size, and compared as a run compares
the program. Its numbers have to fail at least one of the cell's limits.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed: the numbers, the limits and whether the
control failed them. The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control(cell: str, seed: int) -> dict:
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import torch

    from harness import checks, spec

    bench = spec.load_benchmark(ROOT)
    wl = spec.workload(bench, cell)
    cfg = spec.config(bench, wl["config"], ROOT)
    mix = spec.traffic(cell)
    c = spec.driver(mix["driver"]).Cell(cfg, mix, seed,
                                        torch.device("cuda", 0))
    numbers = c.control()
    readings = checks.hold(numbers, mix["limits"])
    return dict(cell=cell, seed=seed, numbers=numbers,
                limits=mix["limits"], failed=not checks.passed(readings))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for s in args.seeds:
        print(json.dumps(control(args.workload, s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
