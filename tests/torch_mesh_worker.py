"""One process of the port's 2-D mesh CPU tests (``tests/test_torch_mesh.py``):
it joins a gloo group, makes a (dp, tp) mesh and runs one of

    tp    the eval forward, channel-sharded over a 1 x 2 mesh;
    sp    the eval forward on row shards of a 1 x 2 mesh, the sampler on
          its whole-scan route, and a fused 1x1 site whose kernel
          refuses its row shard;
    step  one train step on a 2 x 2 mesh (channel-sharded, the batch
          split over data), its gathered gradients, then the gathered
          checkpoint, and its restore into a fresh sharded run;
    one   one train step on a 1 x 1 mesh in a group of one;
    none  the same step with no group at all.

    python tests/torch_mesh_worker.py <mode> <rank> <nproc> <rendezvous> <in.pt> <out.pt>

``rendezvous`` is the group's ``host:port`` or an init URL
(``file:///path``).

``in.pt`` holds the model's keyword arguments, the eval and the train
state dicts (whole tensors), the events and labels and the lr. Rank 0
writes what the test compares.
"""

import os
import sys
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from eas_snn_tpu_torch import parallel  # noqa: E402
from eas_snn_tpu_torch.models import blocks  # noqa: E402
from eas_snn_tpu_torch.parallel import mesh as pmesh  # noqa: E402


def _model(d, state, train):
    from eas_snn_tpu_torch.models import EASYOLOX

    model = EASYOLOX(**d["kwargs"])
    model.load_state_dict(state, strict=True)
    return model.train(train)


def eval_forward(d, mode, rank, out):
    mesh = parallel.make_mesh_2d(1, 2)
    model = _model(d, d["eval_state"], False)
    with torch.no_grad():
        if mode == "tp":
            parallel.channel_shard_params(mesh, model)
            y = model(d["events"])
        else:
            sp = parallel.spatial_sharding(mesh)
            with sp:
                y = model(sp(d["events_sp"]))
                # the whole-scan sampler's route (its plain version here),
                # its spikes' halo refreshed between the micro-steps
                model.embedding.fused_sampler = "always"
                v2 = model.embedding(sp(d["events_sp"]))
            v2 = pmesh.gather_rows(v2, mesh)
            # a fused 1x1 site whose kernel refuses its row shard (as the
            # card's does at a 4- or 2-row stride-32 shard): it warns,
            # gathers its rows and keeps its part of the whole map
            model.embedding.fused_sampler = "never"
            site = model.backbone.backbone.dark5[2].conv3
            site.neuron = site.neuron._replace(fuse="always")
            whole = model(d["events_sp"])
            blocks.layout_refusal = lambda xs, k, stride=1: "refused"
            with sp, warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                gathered = model(sp(d["events_sp"]))
            refused = dict(whole=whole, gathered=gathered, warned=sum(
                "gathers its rows" in str(w.message) for w in caught))
    if rank == 0:
        torch.save(dict(out=y, v2=v2 if mode == "sp" else None,
                        refused=refused if mode == "sp" else None, sharded={
            k: tuple(v.shape) for k, v in model.state_dict().items()
            if k in pmesh.sharded_keys(model)}), out)


def step(d, dp, tp, rank, out):
    from eas_snn_tpu_torch.core import (CheckpointManager, build_lr_schedule,
                                        build_optimizer, init_ema, train_step)
    from eas_snn_tpu_torch.core.train_state import broadcast_state

    mesh = parallel.make_mesh_2d(dp, tp)

    def build():
        model = _model(d, d["step_state"], True)
        parallel.channel_shard_params(mesh, model)
        opt = build_optimizer(model, build_lr_schedule("fixed", d["lr"], 10,
                                                       10),
                              weight_decay=5e-4)
        return model, opt

    model, opt = build()
    if mesh.data_index != 0:  # the broadcast must bring the state back
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    ema = init_ema(model)
    broadcast_state(model, ema)
    batch, _ = parallel.dp_tp_shardings(mesh)
    losses = train_step(model, opt, ema, batch(d["events"]),
                        batch(d["labels"]), to_host=True)
    grads = pmesh.gather_state(model, {n: p.grad for n, p in
                                       model.named_parameters()})
    ckpt = CheckpointManager(os.path.join(os.path.dirname(out), "ckpt"))
    ckpt.save(1, model, opt, ema)
    if parallel.is_initialized():
        torch.distributed.barrier()
    # the whole checkpoint back into a fresh sharded run
    model2, opt2 = build()
    ema2 = init_ema(model2)
    ckpt.restore(model2, opt2, ema2)
    same = all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), model2.state_dict().values()))
    same &= all(torch.equal(ema[k], ema2[k]) for k in ema)
    st, st2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    same &= all(torch.equal(torch.as_tensor(st[i][k]),
                            torch.as_tensor(st2[i][k]))
                for i in st for k in st[i])
    if rank == 0:
        torch.save(dict(losses=losses, restored_equal=same, grads=grads,
                        ckpt=ckpt.path(1),
                        sharded=sorted(pmesh.sharded_keys(model)),
                        state={k: v.clone() for k, v in
                               model.state_dict().items()}), out)


def main():
    mode, rank, nproc, rdzv, inp, out = sys.argv[1:7]
    rank, nproc = int(rank), int(nproc)
    torch.set_num_threads(1)
    if mode != "none":
        parallel.start_group(rdzv, nproc, rank, device="cpu")
    try:
        d = torch.load(inp, weights_only=False)
        if mode in ("tp", "sp"):
            eval_forward(d, mode, rank, out)
        elif mode == "step":
            step(d, 2, 2, rank, out)
        else:
            step(d, 1, 1, rank, out)
    finally:
        parallel.shutdown()


if __name__ == "__main__":
    main()
