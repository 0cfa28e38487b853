"""Export CLI of the port: the eval forward as a ``torch.export`` program
(counterpart of ``tools/export_stablehlo.py`` and
``tools/export_savedmodel.py``).

    python -m eas_snn_tpu_torch.tools.export -n gen1_syolox_m -o out/m \\
        [-f exp.py] [-c best.pth] [-b 1] [--device cuda] [--no-verify] \\
        [key value ...]

Exports ``model(events) -> predictions`` (the decoded (B, A, 5 + C)
outputs before NMS, what the JAX tools export as ``model.apply(...,
train=False)``) at the static shape (``-b``, Tl, Tm, *test_size, in_dim)
and writes:

* ``<o>.pt2``: ``torch.export.save`` of the program, the weights in its
  state dict (the SavedModel's variables), not baked into the graph;
* ``<o>.txt``: the program's readable graph (the ``.mlir``'s
  counterpart).

It prints one line with the sizes. ``-c`` takes a checkpoint of the port
(its EMA where it has one), a reference ``.pth`` state dict or a zoo name;
without it the weights are the exp's seeded draw. The exp's fields,
``deploy()``'s among them (``compute_dtype bfloat16
embedding_state_dtype bfloat16 fused_sampler auto``), are set by the
``key value`` pairs after the flags.

The program is traced on ``--device`` (``cuda`` by default, ``cpu`` when
asked) and runs there. The eval kernels are registered ops
(``ops/library.py``) and stay nodes of the graph, which run the kernels on
the card and their plain versions on the CPU; a choice the forward makes
by device at trace time is baked in (``fused_sampler auto`` takes the
whole-scan sampler kernel only when traced on the card). A saved program
names the ops, so loading it needs ``import eas_snn_tpu_torch`` first:
:func:`load_exported` does both. The RGB presets hold no kernel op, as
the JAX package's RGB models run no Pallas kernel.

Verify (on by default, ``--no-verify`` skips it) reloads the ``.pt2``,
runs it on seeded ``normal(0)`` events (the JAX SavedModel tool's check)
and holds it to the eager forward within 1e-4, printing the largest
difference and whether the two are bit-equal (the same kernels run in the
same order, so they should be).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["make_parser", "export_program", "load_exported", "main",
           "kernel_ops", "VERIFY_TOL"]

# the JAX export tool's bound on the reloaded artifact's difference
VERIFY_TOL = 1e-4


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "eas_snn_tpu_torch export",
        description="Export the eval forward as a torch.export program. "
                    "It is traced on --device and runs there: choices the "
                    "forward makes by device are baked into the graph (a "
                    "program exported on the card holds the kernels' "
                    "routes, one exported on the CPU the plain ones); the "
                    "kernels are registered ops, which `import "
                    "eas_snn_tpu_torch` must register before a load.")
    p.add_argument("-n", "--name", type=str, default=None,
                   help="exp name (a preset of the port)")
    p.add_argument("-f", "--exp_file", type=str, default=None,
                   help="exp file whose Exp subclasses the port's EventExp "
                        "or YOLOXExp")
    p.add_argument("-c", "--ckpt", type=str, default=None,
                   help="weights: a checkpoint of the port, a reference "
                        ".pth state dict or a zoo name")
    p.add_argument("-o", "--output", type=str, default="model_export",
                   help="output path without suffix: <o>.pt2 and <o>.txt")
    p.add_argument("-b", "--batch-size", type=int, default=1,
                   help="the program's static batch")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu': where the program is "
                        "traced and runs")
    p.add_argument("--no-verify", action="store_true",
                   help="skip the reload and the check against the eager "
                        "forward")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                   help="free-form 'key value' config overrides")
    return p


def export_program(model: torch.nn.Module, sample: torch.Tensor
                   ) -> torch.export.ExportedProgram:
    """``torch.export.export`` of the eval forward ``model(sample)``."""
    with torch.no_grad():
        return torch.export.export(model.eval(), (sample,))


def load_exported(path: str) -> torch.export.ExportedProgram:
    """A saved program, after the port's op registrations."""
    import eas_snn_tpu_torch.ops  # noqa: F401  (registers eas_snn::*)

    return torch.export.load(path)


def kernel_ops(program: torch.export.ExportedProgram) -> dict:
    """{op name: calls} of the port's registered kernel ops in the
    program's graph."""
    from ..ops.library import NAMESPACE

    counts: dict = {}
    for node in program.graph.nodes:
        name = getattr(node.target, "name", lambda: "")()
        if node.op == "call_function" and name.startswith(NAMESPACE + "::"):
            key = name.split("::")[1]
            counts[key] = counts.get(key, 0) + 1
    return counts


def sample_events(exp, batch: int, device, seed: Optional[int] = None
                  ) -> torch.Tensor:
    """The program's input shape (batch, Tl, Tm, *test_size, in_dim) in
    f32: zeros, or ``normal(0)`` from ``seed`` (numpy)."""
    h, w = exp.test_size
    shape = (batch, exp.Tl, exp.Tm, h, w, exp.in_dim)
    if seed is None:
        return torch.zeros(shape, device=device)
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from ..core.checkpoint import load_eval_weights
    from ..exp.build import exp_from_args
    from ..exp.event_exp import resolve_device
    from ..models.build import zoo_path

    args = make_parser().parse_args(argv)
    exp = exp_from_args(args.exp_file, args.name)
    if args.opts:
        exp.merge(args.opts)
    exp.apply_precision()
    device = resolve_device(args.device)
    model = exp.get_model(device=device, seed=exp.seed or 0)
    if args.ckpt:
        load_eval_weights(model, zoo_path(args.ckpt))
    out = args.output
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)

    t0 = time.perf_counter()
    program = export_program(model, sample_events(exp, args.batch_size,
                                                  device))
    t1 = time.perf_counter()
    torch.export.save(program, out + ".pt2")
    with open(out + ".txt", "w") as f:
        f.write(str(program))
    t2 = time.perf_counter()
    size = os.path.getsize(out + ".pt2")
    ops = kernel_ops(program)
    print(f"exported torch.export program: {out}.pt2 ({size / 1e6:.1f} MB, "
          f"{len(program.state_dict)} weights, kernel ops "
          f"{sum(ops.values())}) + {out}.txt "
          f"({os.path.getsize(out + '.txt') / 1e6:.1f} MB)")
    result = {"pt2": out + ".pt2", "txt": out + ".txt", "bytes": size,
              "weights": len(program.state_dict), "kernel_ops": ops,
              "trace_s": t1 - t0, "save_s": t2 - t1}
    if args.no_verify:
        return result

    t3 = time.perf_counter()
    reloaded = load_exported(out + ".pt2")
    result["load_s"] = time.perf_counter() - t3
    x = sample_events(exp, args.batch_size, device, seed=0)
    with torch.no_grad():
        got = reloaded.module()(x)
        want = model(x)
    err = float((got.float() - want.float()).abs().max())
    same = bool(torch.equal(got, want))
    print(f"verify: the reloaded program against the eager forward: "
          f"max|diff|={err:.3e}, bit-equal {same}")
    if not err < VERIFY_TOL:
        raise SystemExit(f"the reloaded program diverges from the eager "
                         f"forward: max|diff|={err:.3e} >= {VERIFY_TOL}")
    result.update(max_abs=err, bit_equal=same)
    return result


if __name__ == "__main__":
    main()
