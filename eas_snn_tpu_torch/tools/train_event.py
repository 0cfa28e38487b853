"""Training CLI of the port (counterpart of ``tools/train_event.py:24-86``;
reference tools/train_event.py:24-162): an experiment by name or from a
file, batch size, resume or fine-tune, free-form ``key value``
overrides.

    python -m eas_snn_tpu_torch.tools.train_event -n gen1_syolox_m -b 64 \\
        data_dir /data/gen1 [--resume | -c ckpt.pth] [--profile N] \\
        [key value ...]
    python -m eas_snn_tpu_torch.tools.train_event -f my_exp.py ...

``-f`` loads a Python file whose ``Exp`` class subclasses
``eas_snn_tpu_torch.exp.EventExp``; ``-n`` names a preset of the port.

Runs on the card (``--device cuda``, the default) with the step captured
as CUDA graphs, or on the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

__all__ = ["make_parser", "build", "main"]


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "eas_snn_tpu_torch train",
        epilog="-f loads a Python file whose Exp class subclasses "
               "eas_snn_tpu_torch.exp.EventExp (a file that imports the JAX "
               "package is refused); -n names a preset of the port. "
               "Multi-process and multi-host training (the JAX CLI's "
               "--num_processes, --coordinator, --process_id) waits for the "
               "distributed slice of the port (ROADMAP.md §1 item 10).")
    parser.add_argument("-expn", "--experiment-name", type=str, default=None)
    parser.add_argument("-n", "--name", type=str, default=None,
                        help="exp name (a preset of the port)")
    parser.add_argument("-f", "--exp_file", type=str, default=None,
                        help="exp file: a Python file whose Exp class "
                             "subclasses eas_snn_tpu_torch.exp.EventExp "
                             "(taken before -n)")
    parser.add_argument("-b", "--batch-size", type=int, default=64)
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
    exp, args = build(argv)
    exp.get_trainer(args, device=args.device).train()


if __name__ == "__main__":
    main()
