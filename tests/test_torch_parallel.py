"""The port's data-parallel training on the CPU: real processes in a gloo
group (``tests/torch_mp_worker.py``) against the single-process step and
the JAX package's step, the train command line on two processes, the
evaluator's gather under the trainer, and the capturable SGD.

The JAX package trains data-parallel as one jitted step over a batch
sharded on a mesh, so its BN statistics, SimOTA's foreground count and
its gradient are the global batch's (``tests/test_parallel.py``,
``tests/test_multiprocess.py``); the port's processes must give the same
step. The geometry is ``tests/mp_worker.py``'s: 64x64, a global batch of
2, width 0.125.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from eas_snn_tpu.core import optim as joptim
from eas_snn_tpu.core.train_state import create_train_state
from eas_snn_tpu.core.train_state import train_step as j_train_step
from eas_snn_tpu.models import EASYOLOX as JEASYOLOX

from eas_snn_tpu_torch import parallel
from eas_snn_tpu_torch.core import optim as poptim

from test_torch_data import write_tree
from test_torch_model import SMALL, _random_variables
from test_torch_train_step import _labels, _torch_tree

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_mp_worker.py")
LR = 1e-3
TIMEOUT = 240  # seconds, each group of worker processes


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argvs, timeout=TIMEOUT):
    """Run the command lines together; each must exit 0."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env, text=True,
                              cwd=REPO) for a in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, f"process failed (rc={rc}):\n{out}\n{err[-4000:]}"
    return outs


def _workers(mode, groups, arg, out):
    """For each ``nproc`` of ``groups``, that many worker processes in a
    gloo group (0: one process with no group), all started together;
    rank 0's result of each group, by ``nproc``."""
    argvs = []
    for n in groups:
        port = str(_free_port())
        argvs += [[sys.executable, WORKER, mode, str(r), str(n), port, arg,
                   out.format(n)] for r in range(max(n, 1))]
    _spawn(argvs)
    return {n: torch.load(out.format(n), weights_only=False) for n in groups}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """One SGD step from the same weights and global batch: JAX's, and the
    port's with no group, a group of one and a group of two. SGD's update
    is linear in the gradient, so the parameters show how far the
    gradients agree (Adam's first step would move every near-zero
    gradient by +-lr on the sign of its rounding noise: ~20% of some
    spiking conv kernels' elements here)."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    ev = rng.poisson(0.2, (2, 1, 4, 64, 64, 2)).astype(np.float32)
    lab = _labels()
    jm = JEASYOLOX(use_spike="backbone", embedding="arsnn", **SMALL)
    v = _random_variables(jm, ev, rng)

    def loss_fn(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, ev, lab,
                            train=True, mutable=["batch_stats"])
        return out["total_loss"], out

    (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        v["params"])
    tx = joptim.build_optimizer(v["params"], joptim.build_lr_schedule(
        "fixed", LR, 1, 1), optimizer="SGD")
    state = create_train_state(jm, None, None, None, tx, variables=v)
    state, _ = j_train_step(state, ev, lab)
    inp = str(tmp / "in.pt")
    torch.save(dict(kwargs=dict(use_spike="backbone", **SMALL),
                    state=_torch_tree(v), events=torch.from_numpy(ev),
                    labels=torch.from_numpy(lab), lr=LR, optimizer="SGD"),
               inp)
    port = _workers("step", (0, 1, 2), inp, str(tmp / "out{}.pt"))
    return dict(port=port, jax=dict(
        metrics={k: float(x) for k, x in metrics.items()},
        grads=_torch_tree({"params": grads}),
        state=_torch_tree({"params": state.params,
                           "batch_stats": state.batch_stats})))


def test_no_group_means_one_process():
    assert not parallel.is_initialized()
    assert (parallel.rank(), parallel.world_size()) == (0, 1)
    parallel.initialize_distributed("127.0.0.1:1", 1, 0, device="cpu")
    assert not parallel.is_initialized()  # one process: a no-op, as JAX's
    t = torch.arange(3.0)
    assert parallel.all_reduce_sum_(t) is t and t.tolist() == [0, 1, 2]


def test_group_of_one_gives_the_bits_of_no_group(steps):
    """A gloo group of one process runs every collective of the step (the
    BN sites', SimOTA's counts, the gradient bucket) and must give the
    single-process step's bits: each share is 1.0."""
    a, b = steps["port"][0], steps["port"][1]
    assert a["losses"] == b["losses"]
    for what in ("grads", "state", "ema"):
        assert a[what].keys() == b[what].keys()
        for k in a[what]:
            assert torch.equal(a[what][k], b[what][k]), (what, k)


def test_two_process_step_equals_one_process_step(steps):
    """Two processes, one sample each, against one process on both
    samples: the loss within 1e-5, parameters, EMA and BN running
    statistics within tests/test_parallel.py's rtol 2e-3 / atol 2e-4 (f32
    sums in another order), gradients within 1e-3 of each tensor's
    largest magnitude. Rank 1 started from other weights: the step began
    from rank 0's broadcast state."""
    one, two = steps["port"][0], steps["port"][2]
    for k in ("total_loss", "iou_loss", "conf_loss", "cls_loss"):
        assert abs(one["losses"][k] - two["losses"][k]) < 1e-5, k
    assert one["losses"]["num_fg"] == two["losses"]["num_fg"] > 0
    for k, g in one["grads"].items():
        np.testing.assert_allclose(two["grads"][k].numpy(), g.numpy(),
                                   rtol=0, atol=1e-3 * float(g.abs().max()),
                                   err_msg=k)
    for what in ("state", "ema"):
        for k, x in one[what].items():
            np.testing.assert_allclose(
                two[what][k].double().numpy(), x.double().numpy(),
                rtol=2e-3, atol=2e-4, err_msg=f"{what} {k}")
    run = [k for k in one["state"] if k.endswith("running_var")]
    assert run and all(not torch.equal(one["state"][k],
                                       torch.ones_like(one["state"][k]))
                       for k in run)


def test_two_process_step_holds_to_jax(steps):
    """The port's two-process step against the JAX package's
    single-process ``train_step`` from the same weights: loss terms within
    1e-5 relative, every gradient and BN running statistic within 1e-3
    of its tensor's largest magnitude, every parameter within 1e-3 of
    its tensor's largest magnitude times 2 lr (the SGD update's share of
    the gradient tolerance)."""
    two, want = steps["port"][2], steps["jax"]
    for k in ("total_loss", "iou_loss", "conf_loss", "cls_loss"):
        np.testing.assert_allclose(two["losses"][k], want["metrics"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert two["grads"].keys() == want["grads"].keys()
    for k, g in want["grads"].items():
        tol = 1e-3 * float(g.abs().max())
        np.testing.assert_allclose(two["grads"][k].numpy(), g.numpy(),
                                   rtol=0, atol=tol + 1e-12, err_msg=k)
    for k, x in want["state"].items():
        if k.endswith("num_batches_tracked"):  # no JAX counterpart
            continue
        got = two["state"][k].numpy()
        if k.endswith(("running_mean", "running_var")):
            tol = 1e-3 * float(np.abs(x.numpy()).max())
        elif k in want["grads"]:
            tol = 2 * LR * 1e-3 * float(want["grads"][k].abs().max()) + 1e-7
        else:
            tol = 0.0
        np.testing.assert_allclose(got, x.numpy(), rtol=0, atol=tol,
                                   err_msg=k)


def _cli(tree, out, *extra):
    return [sys.executable, "-m", "eas_snn_tpu_torch.tools.train_event",
            "-n", "gen1_syolox_s", "-b", "4", "-l", "jsonl", "--device",
            "cpu", *extra, "data_dir", tree, "output_dir", out, "width",
            "0.125", "depth", "0.33", "compute_dtype", "float32",
            "input_size", "(32, 32)", "test_size", "(32, 32)",
            "data_num_workers", "0", "print_interval", "1", "max_epoch",
            "1", "eval_interval", "1", "seed", "1", "max_events_per_slice",
            "4096"]


def test_train_cli_on_two_processes(tmp_path):
    """``--num_processes 2`` through the train CLI on a Gen1 tree: both
    processes train the global batch of 4 (2 samples each) and evaluate
    through the gather; only rank 0 logs, writes the metrics and saves
    the checkpoint."""
    tree = write_tree(str(tmp_path / "gen1"), groups=3)
    out = str(tmp_path / "out")
    port = str(_free_port())
    outs = _spawn([_cli(tree, out, "--num_processes", "2", "--coordinator",
                        f"127.0.0.1:{port}", "--process_id", str(r))
                   for r in range(2)])
    run = os.path.join(out, "gen1_syolox_s")
    rows = [json.loads(r) for r in open(os.path.join(run, "metrics.jsonl"))]
    train = [r for r in rows if r["split"] == "train"]
    val = [r for r in rows if r["split"] == "val"]
    assert train and all(np.isfinite(r["total_loss"]) for r in train)
    assert len(val) == 1 and 0.0 <= val[0]["AP50_95"] <= 1.0
    steps = train[-1]["step"]
    assert os.path.exists(os.path.join(run, "ckpt", f"ckpt_{steps}.pth"))
    log = open(os.path.join(run, "train_log.txt")).read()
    assert "batch 4 (2 a process, 2 processes)" in log
    assert "INFO" in outs[0][2] and "INFO" not in outs[1][2]


def test_evaluator_gathers_every_rank_under_the_trainer(tmp_path):
    """The trainer's evaluation on two processes: each runs its
    rank-strided half of the val split and ``_allgather_rows`` gives
    every rank all rows; the rows and the AP equal one process's."""
    tree = write_tree(str(tmp_path / "gen1"), groups=3)
    for n in (0, 2):
        os.makedirs(tmp_path / f"run{n}")
    res = _workers("eval", (0, 2), tree, str(tmp_path / "run{}" / "e.pt"))
    one, two = res[0], res[2]

    def rows(t):
        a = t.numpy()
        return a[np.lexsort(a.T[::-1])]

    assert len(one["gt"]) > 0 and len(one["det"]) > 0
    np.testing.assert_array_equal(rows(two["gt"]), rows(one["gt"]))
    np.testing.assert_allclose(rows(two["det"]), rows(one["det"]),
                               rtol=1e-6, atol=1e-6)
    assert two["samples"] < one["samples"]  # rank 0's share only
    assert two["ap"] == pytest.approx(one["ap"], abs=1e-9)


# ------------------------------------------------------------------- SGD

class _Groups(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.embedding = torch.nn.Conv2d(2, 4, 3)
        self.conv = torch.nn.Conv2d(4, 8, 3)
        self.scale = torch.nn.Parameter(torch.ones(8))


def test_capturable_sgd_equals_torch_sgd():
    """Three updates of :class:`SGD` (a 0-d tensor lr a group, what a CUDA
    graph captures) against ``torch.optim.SGD`` (Nesterov, float lrs) on
    the same groups, weight decay and emb_lr scale: the same bits."""
    torch.manual_seed(0)
    mine, ref = _Groups(), _Groups()
    ref.load_state_dict(mine.state_dict())
    sched = poptim.build_lr_schedule("yoloxwarmcos", 1e-2, 2, 3,
                                     warmup_epochs=1)
    opt = poptim.build_optimizer(mine, sched, optimizer="SGD",
                                 weight_decay=5e-2, momentum=0.9,
                                 emb_lr=3e-3, base_lr=1e-2)
    assert isinstance(opt, poptim.SGD)
    assert all(g["capturable"] and isinstance(g["lr"], torch.Tensor)
               for g in opt.param_groups)
    groups = [dict(params=[ref.conv.weight], weight_decay=5e-2, scale=1.0),
              dict(params=[ref.conv.bias, ref.scale], weight_decay=0.0,
                   scale=1.0),
              dict(params=list(ref.embedding.parameters()),
                   weight_decay=0.0, scale=0.3)]
    torch_opt = torch.optim.SGD(groups, lr=1.0, momentum=0.9, nesterov=True)
    g = torch.Generator().manual_seed(1)
    for step in range(3):
        for p, q in zip(mine.parameters(), ref.parameters()):
            p.grad = torch.randn(p.shape, generator=g)
            q.grad = p.grad.clone()
        poptim.set_learning_rate(opt, step)
        opt.step()
        for grp in torch_opt.param_groups:
            grp["lr"] = sched(step) * grp["scale"]
        torch_opt.step()
        for (n, p), q in zip(mine.named_parameters(), ref.parameters()):
            assert torch.equal(p, q), (step, n)
    assert all("momentum_buffer" in opt.state[p] for p in mine.parameters())
