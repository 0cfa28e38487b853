"""One process of the port's data-parallel CPU tests
(``tests/test_torch_parallel.py``): it joins a gloo group and runs one
train step, or one evaluation under the trainer, on its share of the
global batch, and rank 0 writes what the test compares.

    python tests/torch_mp_worker.py step <rank> <nproc> <port> <in.pt> <out.pt>
    python tests/torch_mp_worker.py eval <rank> <nproc> <port> <data> <out.pt>

``nproc`` 0 runs the plain single-process step with no group at all.
``step`` reads the model's keyword arguments, its state dict, the global
batch and the lr from ``in.pt``; every rank but 0 first moves its
weights away, so that the broadcast of rank 0's state is exercised.
``eval`` builds the trainer of a tiny ``gen1_syolox_s`` over ``data`` and
evaluates the seeded model (every box kept before NMS: confidence
threshold 0), gathering the rows of every rank.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from eas_snn_tpu_torch import parallel  # noqa: E402


def step(rank: int, nproc: int, inp: str, out: str) -> None:
    from eas_snn_tpu_torch.core import (build_lr_schedule, build_optimizer,
                                        init_ema, train_step)
    from eas_snn_tpu_torch.core.train_state import broadcast_state
    from eas_snn_tpu_torch.models import EASYOLOX

    d = torch.load(inp, weights_only=False)
    model = EASYOLOX(**d["kwargs"])
    model.load_state_dict(d["state"], strict=True)
    model.train()
    if rank != 0:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    opt = build_optimizer(model, build_lr_schedule("fixed", d["lr"], 1, 1),
                          optimizer=d.get("optimizer", "ADAM"))
    ema = init_ema(model)
    broadcast_state(model, ema)
    per = d["events"].shape[0] // max(nproc, 1)
    rows = slice(rank * per, (rank + 1) * per)
    losses = train_step(model, opt, ema, d["events"][rows],
                        d["labels"][rows], to_host=True)
    if rank == 0:
        torch.save(dict(
            losses=losses,
            grads={n: p.grad.clone() for n, p in model.named_parameters()
                   if p.grad is not None},
            state={k: v.clone() for k, v in model.state_dict().items()},
            ema={k: v.clone() for k, v in ema.items()}), out)


def evaluate(data: str, out: str) -> None:
    from eas_snn_tpu_torch.tools.train_event import build

    exp, args = build([
        "-n", "gen1_syolox_s", "-b", "2", "-l", "jsonl", "--device", "cpu",
        "data_dir", data, "output_dir", os.path.dirname(out), "width",
        "0.125", "depth", "0.33", "compute_dtype", "float32", "input_size",
        "(32, 32)", "test_size", "(32, 32)", "data_num_workers", "0",
        "seed", "1", "max_events_per_slice", "4096", "test_conf", "0.0"])
    exp.iters_per_epoch = 1
    tr = exp.get_trainer(args, device="cpu")
    tr.before_train()
    tr.evaluate_and_save_model()  # from best AP 0: best_ap is the AP
    ap = tr.best_ap
    det, gt = tr.evaluator.last_rows
    if parallel.rank() == 0:
        torch.save(dict(ap=ap, det=torch.from_numpy(det),
                        gt=torch.from_numpy(gt),
                        samples=tr.evaluator.timing["samples"]), out)
    tr.after_train()


def main() -> None:
    mode, rank, nproc, port = sys.argv[1], *map(int, sys.argv[2:5])
    torch.set_num_threads(2)
    if nproc:
        parallel.start_group(f"127.0.0.1:{port}", nproc, rank, device="cpu")
    try:
        if mode == "step":
            step(rank, nproc, sys.argv[5], sys.argv[6])
        else:
            evaluate(sys.argv[5], sys.argv[6])
    finally:
        parallel.shutdown()
    print(f"RANK{rank}_DONE", flush=True)


if __name__ == "__main__":
    main()
