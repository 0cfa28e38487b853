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
    none  the same step with no group at all;
    sp_step  the train step on row shards
          (``tests/test_torch_mesh_sp_train.py``): on a 1 x 2 mesh the
          halo's backward, the BN statistics of row shards and their
          gradient, the step, its checkpoint, the step with remat and
          either spike store (its backward outside the sharding) and the
          packed sampler's step; on a 2 x 2 mesh (``sp_step22``) and a
          1 x 4 mesh (``sp_step14``) the step; each step's PLIF decay
          logits' gradients also in f64;
    sp_none  the unsharded steps those are held to, with no group.

    python tests/torch_mesh_worker.py <mode> <rank> <nproc> <rendezvous> <in.pt> <out.pt>

``rendezvous`` is the group's ``host:port`` or an init URL
(``file:///path``).

``in.pt`` holds the model's keyword arguments, the eval and the train
state dicts (whole tensors), the events and labels and the lr (for the
``sp`` modes: the train state and each case's mesh, batch and keyword
arguments). Rank 0 writes what the test compares.
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


def _sp_case(d, case):
    """(model keyword arguments, events, labels) of a case of ``sp``."""
    kw = dict(d["kwargs"], **d["cases"][case].get("kwargs", {}))
    c = d["cases"][case]
    return kw, c["events"], c["labels"]


def _sp_model(d, kw):
    from eas_snn_tpu_torch.core import (build_lr_schedule, build_optimizer,
                                        init_ema)
    from eas_snn_tpu_torch.models import EASYOLOX

    model = EASYOLOX(**kw)
    model.load_state_dict(d["step_state"], strict=True)
    model.train()
    opt = build_optimizer(model, build_lr_schedule("fixed", d["lr"], 10, 10),
                          weight_decay=5e-4)
    return model, opt, init_ema(model)


def _after(model, opt, ema, losses):
    return dict(losses=losses, grads={n: p.grad.clone() for n, p in
                                      model.named_parameters()},
                state={k: v.clone() for k, v in model.state_dict().items()},
                ema={k: v.clone() for k, v in ema.items()})


def _decay_grads64(d, kw, ev, lab, mesh=None):
    """The PLIF decay logits' gradients (``*.act.w``) of one forward and
    backward in float64 (a float64 copy of the model, its sites computing
    in f64), reduced as the step reduces them: on row shards of ``mesh``
    where one is given, else unsharded. Each is a sum over its whole
    site that cancels, which f32 rounds by up to ~1e-3 of itself in
    another order."""
    from eas_snn_tpu_torch.core.train_state import reduce_gradients

    model, _, _ = _sp_model(d, dict(kw, compute_dtype=torch.float64))
    model = model.double()
    ev, lab = ev.double(), lab.double()
    if mesh is None:
        model(ev, lab)["total_loss"].backward()
    else:
        sp = parallel.spatial_sharding(mesh)
        with sp:
            losses = model(sp(ev), parallel.shard_batch(mesh, lab))
            (losses["total_loss"] * pmesh.loss_scale(model)).backward()
            reduce_gradients(model, {k: v.detach()
                                     for k, v in losses.items()})
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if n.endswith(".act.w")}


def sp_none(d, out):
    """The unsharded step of every case, each from the same state, and
    its decay logits' gradients in f64."""
    from eas_snn_tpu_torch.core import train_step

    res = {}
    for case in d["cases"]:
        kw, ev, lab = _sp_case(d, case)
        model, opt, ema = _sp_model(d, kw)
        losses = train_step(model, opt, ema, ev, lab, to_host=True)
        res[case] = _after(model, opt, ema, losses)
        res[case]["grads64"] = _decay_grads64(d, kw, ev, lab)
    torch.save(res, out)


def _gather_whole(x, mesh):
    """The whole of a row-and-batch-sharded tensor (no gradient): rows
    over the model group, then the batch over the data group."""
    with torch.no_grad():
        x = pmesh.gather_rows(x, mesh)
        return torch.cat(parallel.all_gather(x, mesh.data_group), 0)


def _halo_checks(mesh):
    """``over_rows`` of a conv (k = 3, 5 and a 3 x 3 of stride 2) on this
    process's rows against the whole image's conv: the output, the
    input's gradient (the halo rows' cotangents sent back to their
    owners) and the weight's gradient summed over the group, each as the
    largest |difference|."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(5)
    res = {}
    for k, stride in ((3, 1), (5, 1), (3, 2)):
        x = torch.randn(2, 3, 16, 8, generator=g, dtype=torch.float64)
        w = torch.randn(4, 3, k, k, generator=g, dtype=torch.float64)
        cot = torch.randn(2, 4, 16 // stride, 8 // stride, generator=g,
                          dtype=torch.float64)

        def conv(t, w):
            return F.conv2d(t, w, stride=stride, padding=k // 2)

        xw, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        yw = conv(xw, ww)
        (yw * cot).sum().backward()
        n, m = 16 // mesh.tp, mesh.model_index
        xs = x[..., m * n:(m + 1) * n, :].clone().requires_grad_()
        ws = w.clone().requires_grad_()
        ys = pmesh.over_rows(xs, lambda t: conv(t, ws), k, stride, mesh)
        no = n // stride
        (ys * cot[..., m * no:(m + 1) * no, :]).sum().backward()
        gw = parallel.all_reduce_sum_(ws.grad.clone(), mesh.model_group)
        res[(k, stride)] = dict(
            out=float((pmesh.gather_rows(ys.detach(), mesh)
                       - yw.detach()).abs().max()),
            dx=float((pmesh.gather_rows(xs.grad, mesh) - xw.grad)
                     .abs().max()),
            dw=float((gw - ww.grad).abs().max()),
            dx_scale=float(xw.grad.abs().max()))
    return res


def _bn_checks(mesh):
    """``_BatchStats`` on this process's rows of its batch share (the
    forward inside the sharding, the backward outside it) against the
    whole batch's statistics and the gradient of the whole batch, as the
    largest |difference| and the reference's scale. The loss of the
    statistics is every process's, so each back-propagates its 1 / (dp x
    tp) share of it, as a model group back-propagates its shared loss."""
    g = torch.Generator().manual_seed(6)
    B = 2 * mesh.dp
    x = torch.randn(B, 5, 8 * mesh.tp, 6, generator=g) * 3 + 1
    a, b = torch.randn(5, generator=g), torch.randn(5, generator=g)
    with pmesh.spatial_context(None):
        xw = x.clone().requires_grad_()
        # the whole batch with no group: the statistics of one process
        mean_w = xw.float().mean((0, 2, 3))
        var_w = torch.clamp_min((xw * xw).mean((0, 2, 3)) - mean_w ** 2, 0)
        ((mean_w * a).sum() + (var_w * b).sum()).backward()
    sp = pmesh.SpatialSharding(mesh, h_axis=2, ndim=4, multiple=8)
    xs = sp(x).clone().requires_grad_()
    with sp:
        mean, var = blocks._BatchStats.apply(xs)
    share = 1.0 / (mesh.dp * mesh.tp)
    # outside the context: the forward's group holds
    (((mean * a).sum() + (var * b).sum()) * share).backward()
    return dict(mean=float((mean - mean_w).abs().max()),
                var=float((var - var_w).abs().max()),
                dx=float((_gather_whole(xs.grad, mesh) - xw.grad)
                         .abs().max()),
                dx_scale=float(xw.grad.abs().max()))


def _sp_grads(d, kw, mesh, ev, lab):
    """The reduced gradients and moved BN statistics of one SP step's
    forward and backward (no update), the forward inside the sharding
    and the backward outside it (a recompute must bring its own)."""
    from eas_snn_tpu_torch.core.train_state import reduce_gradients

    model, _, _ = _sp_model(d, kw)
    sp = parallel.spatial_sharding(mesh)
    with sp:
        losses = model(sp(ev), parallel.shard_batch(mesh, lab))
        scale = pmesh.loss_scale(model)
    (losses["total_loss"] * scale).backward()
    with sp:
        reduce_gradients(model, {k: v.detach() for k, v in losses.items()})
    return dict(grads={n: p.grad.clone() for n, p in
                       model.named_parameters()},
                buffers={k: v.clone() for k, v in model.named_buffers()})


def sp_step(d, dp, tp, rank, out):
    """The SP train step of the cases of this mesh, and on 1 x 2 the
    checks of its parts (module docstring)."""
    from eas_snn_tpu_torch.core import CheckpointManager, train_step

    mesh = parallel.make_mesh_2d(dp, tp)
    res = {}
    if (dp, tp) == (1, 2):
        res["halo"] = _halo_checks(mesh)
        res["bn"] = _bn_checks(mesh)
    for case, c in d["cases"].items():
        if tuple(c["mesh"]) != (dp, tp):
            continue
        kw, ev, lab = _sp_case(d, case)
        model, opt, ema = _sp_model(d, kw)
        sp = parallel.spatial_sharding(mesh)
        with sp:
            losses = train_step(model, opt, ema, sp(ev),
                                parallel.shard_batch(mesh, lab),
                                to_host=True)
        res[case] = _after(model, opt, ema, losses)
        res[case]["grads64"] = _decay_grads64(d, kw, ev, lab, mesh)
        if case != "sp12":
            continue
        # the checkpoint: every tensor replicated, rank 0 writes it
        ckpt = CheckpointManager(os.path.join(os.path.dirname(out), "ckpt"))
        ckpt.save(1, model, opt, ema)
        torch.distributed.barrier()
        model2, opt2, ema2 = _sp_model(d, kw)
        ckpt.restore(model2, opt2, ema2)
        same = all(torch.equal(a, b) for a, b in zip(
            model.state_dict().values(), model2.state_dict().values()))
        same &= all(torch.equal(ema[k], ema2[k]) for k in ema)
        st, st2 = opt.state_dict()["state"], opt2.state_dict()["state"]
        same &= all(torch.equal(torch.as_tensor(st[i][k]),
                                torch.as_tensor(st2[i][k]))
                    for i in st for k in st[i])
        # a second step of the restored run gives the live run's bits
        with sp:
            l1 = train_step(model, opt, ema, sp(ev),
                            parallel.shard_batch(mesh, lab), to_host=True)
            l2 = train_step(model2, opt2, ema2, sp(ev),
                            parallel.shard_batch(mesh, lab), to_host=True)
        same &= l1 == l2 and all(torch.equal(a, b) for a, b in zip(
            model.state_dict().values(), model2.state_dict().values()))
        res["ckpt"], res["restored_equal"] = ckpt.path(1), same
        # remat and the spike store: the gradients' and statistics' bits
        res["remat"] = {}
        for remat, store in ((False, "int8"), (True, "int8"),
                             (True, "float"), (False, "float")):
            res["remat"][(remat, store)] = _sp_grads(
                d, dict(kw, remat=remat, train_store=store), mesh, ev, lab)
    if rank == 0:
        torch.save(res, out)


def main():
    mode, rank, nproc, rdzv, inp, out = sys.argv[1:7]
    rank, nproc = int(rank), int(nproc)
    torch.set_num_threads(1)
    if mode not in ("none", "sp_none"):
        parallel.start_group(rdzv, nproc, rank, device="cpu")
    try:
        d = torch.load(inp, weights_only=False)
        if mode in ("tp", "sp"):
            eval_forward(d, mode, rank, out)
        elif mode == "step":
            step(d, 2, 2, rank, out)
        elif mode == "sp_none":
            sp_none(d, out)
        elif mode.startswith("sp_step"):
            dp, tp = {"sp_step": (1, 2), "sp_step22": (2, 2),
                      "sp_step14": (1, 4)}[mode]
            sp_step(d, dp, tp, rank, out)
        else:
            step(d, 1, 1, rank, out)
    finally:
        parallel.shutdown()


if __name__ == "__main__":
    main()
