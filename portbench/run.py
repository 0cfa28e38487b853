"""One run of one cell of the port's benchmark:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It finds the cell in ``BENCHMARK.json``, its configuration file, its
traffic file (``portbench/traffic/<cell>.json``) and the driver the
traffic names (``portbench/drivers/<driver>.py``); makes the weights and
inputs on the card from the seed; warms up the cell's shapes (set-up);
measures for ``--seconds`` (``--trace 0``: the cell's end-to-end
metrics) or traces a fixed number of the mix's units under
``torch.profiler`` (``--trace 1``: its per-layer metrics, each read by
``portbench/layer_metrics/<metric>.py``); then frees the program's
state, checks what the timed path produced against the plain reference
(``portbench/reference``), prints each compared number beside its limit
on standard error and, as its last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and ``breakdown`` with ``--trace 1``; ``nonfinite_steps`` where the
cell counts steps whose loss is not finite; ``checks`` last). It
refuses to run without the cards the cell asks for, and fails where the
JAX package or JAX was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "eas_snn_tpu")


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc libraries are in its own ``_build`` there)."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(args, overrides=None) -> dict:
    """One run; returns the result object. For tests: ``overrides`` are
    merged into the traffic mix (smaller sizes)."""
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import torch

    from harness import checks, spec

    bench = spec.load_benchmark(ROOT)
    wl = spec.workload(bench, args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < wl["chips"]:
        raise SystemExit(f"portbench: the cell {args.workload} needs "
                         f"{wl['chips']} CUDA device(s); this machine has "
                         f"{have}")
    cfg = spec.config(bench, wl["config"], ROOT)
    mix = dict(spec.traffic(args.workload), **(overrides or {}))
    driver = spec.driver(mix["driver"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cell = driver.Cell(cfg, mix, args.seed, dev)
    cell.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    units = spec.metric_units(bench)
    out = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
           "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(dev), "count": 1}}
    if args.trace:
        rec = cell.traced(args.seconds)
        tr = rec["trace"]
        for m in spec.per_layer(bench, args.workload):
            v = spec.reader(m["name"]).read(rec)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    else:
        rec = cell.window(args.seconds)
        for m in spec.end_to_end(bench, args.workload):
            if m["name"] == "setup_s":
                v = setup_s
            else:
                v = rec["metrics"][m["name"]]
            out["metrics"][m["name"]] = {"value": v, "unit": units[m["name"]]}
    out["attempted"], out["failed"] = rec["attempted"], rec["failed"]
    if "nonfinite_steps" in rec:
        out["nonfinite_steps"] = rec["nonfinite_steps"]
    out["device"]["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
        dev))
    loaded = forbidden_modules()
    if loaded:
        raise SystemExit(f"portbench: the process loaded {loaded} (JAX or the "
                         "JAX package); the port must run without them")
    readings = cell.check()
    out["correct"] = checks.passed(readings) and rec["failed"] == 0
    out["report"] = getattr(cell, "report", [])
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in readings}
    return out


def main(argv=None) -> int:
    _caches()
    args = parse(argv)
    out = run(args)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the process loaded {loaded} (JAX or the JAX "
              "package); no result", file=sys.stderr)
        return 3
    for line in out.pop("report", []):
        print(line, file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
