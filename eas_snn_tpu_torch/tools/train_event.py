"""Training CLI of the port (counterpart of ``tools/train_event.py:24-86``;
reference tools/train_event.py:24-162): an experiment by name or from a
file, batch size, resume or fine-tune, free-form ``key value``
overrides.

    python -m eas_snn_tpu_torch.tools.train_event -n gen1_syolox_m -b 64 \\
        data_dir /data/gen1 [--resume | -c ckpt.pth] [--profile N] \\
        [key value ...]
    python -m eas_snn_tpu_torch.tools.train_event -f my_exp.py ...

``-f`` loads a Python file whose ``Exp`` class subclasses
``eas_snn_tpu_torch.exp.EventExp`` or, for the RGB family,
``eas_snn_tpu_torch.exp.YOLOXExp``; ``-n`` names a preset of the port
(the event presets and the RGB ones: ``yolox_nano`` ... ``yolox_x``,
``yolov3``, ``yolox_voc_s``).

Runs on the card (``--device cuda``, the default) with the step captured
as CUDA graphs, or on the CPU with ``--device cpu``.

Data parallel, one process a card (or a CPU process), each started with
the same command and its own ``--process_id``::

    python -m eas_snn_tpu_torch.tools.train_event -n gen1_syolox_m -b 64 \
        --num_processes 2 --coordinator host:port --process_id 0 \
        data_dir /data/gen1

``-b`` is the global batch, split evenly over the processes (the JAX
trainer feeds its jitted step one global batch of ``-b`` rows sharded
over its mesh); the group speaks NCCL on cards and gloo on the CPU, and
process 0 serves the rendezvous at ``--coordinator``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

__all__ = ["make_parser", "build", "main"]


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "eas_snn_tpu_torch train",
        epilog="-f loads a Python file whose Exp class subclasses "
               "eas_snn_tpu_torch.exp.EventExp or YOLOXExp (a file that "
               "imports the JAX package is refused); -n names a preset of "
               "the port.")
    parser.add_argument("-expn", "--experiment-name", type=str, default=None)
    parser.add_argument("-n", "--name", type=str, default=None,
                        help="exp name (a preset of the port)")
    parser.add_argument("-f", "--exp_file", type=str, default=None,
                        help="exp file: a Python file whose Exp class "
                             "subclasses eas_snn_tpu_torch.exp.EventExp or "
                             "YOLOXExp (taken before -n)")
    parser.add_argument(
        "-b", "--batch-size", type=int, default=64,
        help="the global batch of a step: with --num_processes N each "
             "process loads b / N samples a step from its rank-strided "
             "share of the data (N must divide b), and the lr is that of "
             "the global batch, as the JAX trainer feeds its step one "
             "global batch of b rows")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the run's latest checkpoint")
    parser.add_argument("-c", "--ckpt", type=str, default=None,
                        help="fine-tune checkpoint (shape-checked partial "
                             "load)")
    parser.add_argument("--grid_search", action="store_true")
    parser.add_argument(
        "--fp16", "--bf16", dest="fp16", action="store_true",
        help="bf16 conv/BN train precision (compute_dtype bfloat16; the "
             "counterpart of the reference's --fp16 mixed precision, "
             "reference tools/train_event.py:68-69)")
    parser.add_argument(
        "-l", "--logger", type=str, default="auto",
        choices=["auto", "jsonl", "tensorboard", "wandb"],
        help="metrics backend (JSONL always written; 'auto' adds every "
             "importable backend)")
    parser.add_argument("--profile", type=int, default=0,
                        help="trace N steps with torch.profiler into "
                             "<run dir>/profile")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="data-parallel processes, one a card (NCCL) or "
                             "a CPU process (gloo); 1 or none: one process")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port of the rendezvous, served by "
                             "process 0")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this process's rank, 0 to num_processes - 1")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                        help="free-form 'key value' config overrides")
    return parser


def build(argv: Optional[Sequence[str]] = None):
    """(exp, args) from a command line; sets the exp's precision
    process-wide (``EventExp.apply_precision``)."""
    from ..exp.build import exp_from_args

    args = make_parser().parse_args(argv)
    exp = exp_from_args(args.exp_file, args.name)
    if args.fp16:
        exp.compute_dtype = "bfloat16"  # before merge: explicit opts win
    if args.opts:
        exp.merge(args.opts)
    exp.check_exp_value()
    exp.apply_precision()
    return exp, args


def main(argv: Optional[Sequence[str]] = None) -> None:
    from .. import parallel

    exp, args = build(argv)
    started = (args.num_processes or 1) > 1
    parallel.initialize_distributed(args.coordinator, args.num_processes,
                                    args.process_id, device=args.device)
    try:
        exp.get_trainer(args, device=args.device).train()
    finally:
        if started:
            parallel.shutdown()


if __name__ == "__main__":
    main()
