"""Driver ``train_step``: the port's captured train step
(``core/train_state.py:CapturedStep``, Adam and the EMA of
``core/optim.py``) at the mix's batch, each step on the next batch of a
pool of distinct batches made on the card at set-up.

Set-up builds one step object (model, optimizer, EMA) and drives it
through its first steps on the pool's first batches through the same
call the window makes: the eager warm-up steps of ``CapturedStep``, the
capture with its first replay, then one more replay, the kind of step
the window times. The reference follows the first three steps from the
same weights and batches, and takes the replayed step from the state the
program held before it (parameters, buffers, Adam's moments, the EMA),
kept on the host. The window replays the step back to back, at most two
steps queued ahead of the device, and ends in a synchronize. A step
whose loss is not finite is counted under ``nonfinite_steps``."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from harness import checks, common, trace, traffic
from reference import train as ref_train

CHECKED_STEPS = 3
# the update (counted from 0) of the held replay: the eager steps, then
# the capture with its first replay, then this one
REPLAYED = CHECKED_STEPS + 1


def change_norms(new: Dict[str, torch.Tensor],
                 old: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{leaf: ||new - old||}, one leaf on the device at a time (``old``
    may be on the host)."""
    return {k: float(torch.linalg.vector_norm(
        new[k].double() - old[k].to(new[k].device).double()))
        for k in new}


def host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


class Cell:
    kind = "train"

    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda"):
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, device
        self.B = mix["batch"]
        self.next = 0
        self.marks: List[torch.cuda.Event] = []

    # ------------------------------------------------------------ inputs
    def inputs(self) -> None:
        """The weights and the pool of batches, from the seed."""
        cfg, mix = self.cfg, self.mix
        self.sd = common.state(cfg, self.seed, self.dev)
        gen = torch.Generator(device=self.dev).manual_seed(
            traffic.seeded(self.seed, 3))
        rng = np.random.default_rng(traffic.seeded(self.seed, 4))
        self.events, self.labels = [], []
        for _ in range(mix["pool"]):
            self.events.append(traffic.event_batch(
                mix, cfg["model"], self.B, gen, self.dev))
            self.labels.append(traffic.labels(
                mix, cfg["model"], self.B, rng).to(self.dev))

    def sched(self) -> dict:
        return dict(self.cfg["schedule"], lr=self.cfg["schedule"][
            "lr_per_image"] * self.B, iters_per_epoch=self.mix[
            "iters_per_epoch"])

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from eas_snn_tpu_torch.core.train_state import CapturedStep, \
            init_ema

        self.inputs()
        exp = common.program_exp(self.cfg)
        model = exp.get_model(device=self.dev,
                              seed=traffic.seeded(self.seed, 2), train=True)
        model.load_state_dict(self.sd)
        opt = exp.get_optimizer(model, self.B,
                                iters_per_epoch=self.mix["iters_per_epoch"])
        ema = init_ema(model) if exp.ema else None
        self.model, self.opt, self.ema = model, opt, ema
        self.step = CapturedStep(model, opt, ema)
        params = dict(model.named_parameters())
        p0 = {k: self.sd[k] for k in params}
        losses = []
        for t in range(CHECKED_STEPS):
            out = self.step(self.events[t], self.labels[t])
            losses.append({k: float(v) for k, v in out.items()})
            if t == 0:
                # the first gradient as Adam got it: exp_avg = (1 - b1) g
                g1 = {k: float(torch.linalg.vector_norm(v.double())) / 0.1
                      for k, v in self.moment("exp_avg").items()}
                upd1 = change_norms(self.params(), p0)
        with torch.no_grad():
            upd = change_norms(self.params(), p0)
            emv = change_norms(ema, p0) if ema is not None else {}
        self.got = dict(losses=losses, grad=g1, update=upd, ema=emv,
                        update1=upd1)
        self.next = CHECKED_STEPS
        # the capture and its first replay: the window only replays
        self.call(1)
        common.sync(self.dev)
        self.replay()

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self.model.named_parameters()}

    def moment(self, name: str) -> Dict[str, torch.Tensor]:
        """Adam's ``exp_avg`` or ``exp_avg_sq`` by leaf (zeros for a leaf
        it holds none of)."""
        st = self.opt.state
        return {k: (st[p][name] if p in st else torch.zeros_like(p))
                for k, p in self.model.named_parameters()}

    def replay(self) -> None:
        """One replay through the window's call, on the pool's next batch,
        with the state before it kept on the host for the reference: the
        loss, the gradient as Adam got it (exp_avg = b1 m + (1 - b1) g),
        the change of each leaf and of its EMA."""
        assert self.next == REPLAYED and self.step.replays == 1
        snap = dict(state=host(self.model.state_dict()),
                    m=host(self.moment("exp_avg")),
                    v=host(self.moment("exp_avg_sq")),
                    ema=host(self.ema) if self.ema is not None else {})
        loss = float(self.call(1)[0])
        common.sync(self.dev)
        m = self.moment("exp_avg")
        grad = {k: float(torch.linalg.vector_norm(
            m[k].double() - 0.9 * snap["m"][k].to(self.dev).double()) / 0.1)
            for k in m}
        p0 = {k: snap["state"][k] for k in m}
        self.snap = snap
        self.got_replay = dict(
            losses=[{"total_loss": loss}], grad=grad,
            update=change_norms(self.params(), p0),
            ema=change_norms(self.ema, snap["ema"])
            if self.ema is not None else {})

    def call(self, n: int) -> List[torch.Tensor]:
        """``n`` steps on the pool's next batches, at most two queued ahead
        of the device; their total losses (device tensors)."""
        out = []
        for _ in range(n):
            i = self.next % len(self.events)
            out.append(self.step(self.events[i], self.labels[i])
                       ["total_loss"])
            self.next += 1
            ev = torch.cuda.Event()
            ev.record()
            self.marks.append(ev)
            if len(self.marks) > 2:
                self.marks.pop(0).synchronize()
        return out

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        common.sync(self.dev)
        t0 = time.perf_counter()
        losses = []
        while time.perf_counter() - t0 < seconds:
            losses += self.call(1)
        common.sync(self.dev)
        dt = time.perf_counter() - t0
        return dict(attempted=len(losses), failed=0, window_s=dt,
                    nonfinite_steps=self.nonfinite(losses),
                    metrics={"train_images_per_s": len(losses) * self.B / dt})

    def nonfinite(self, losses: List[torch.Tensor]) -> int:
        """The window's steps whose loss is not finite. They are reported
        and not counted as failed: on this synthetic traffic the recipe
        (Adam at its full rate from step 2, no warm-up) diverges on some
        seeds after some 40 steps, and the plain reference diverges within
        a few steps of the program on the same batches (``PERF.md``);
        every such step still does the whole step's work."""
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        self.notes = [f"nonfinite_steps {bad} of {len(losses)} steps"]
        return bad

    def traced(self, seconds: float) -> dict:
        n = self.mix["trace_units"]
        with trace.traced() as tr:
            with trace.window():
                losses = self.call(n)
                common.sync(self.dev)
        return dict(attempted=n, failed=0, trace=tr, units=n,
                    nonfinite_steps=self.nonfinite(losses),
                    batch=self.B, kind=self.kind, cfg=self.cfg, mix=self.mix)

    # ------------------------------------------------------------ check
    def release(self) -> None:
        """Free the program's state, keeping the checked steps' batches
        and the replayed one's."""
        keep = {i % len(self.events) for i in range(REPLAYED + 1)}
        self.events = {i: self.events[i] for i in keep}
        self.labels = {i: self.labels[i] for i in keep}
        del self.step, self.model, self.opt, self.ema
        common.free(self.dev)

    def batches(self, steps) -> list:
        """The pool's batches of the steps ``steps`` (counted from 0)."""
        n = self.mix["pool"]
        return [(self.events[t % n], self.labels[t % n]) for t in steps]

    def reference(self, dtype: str) -> dict:
        """The reference's first steps in ``dtype`` from the drawn
        weights: its readings (the change of each leaf after the first
        step too)."""
        common.reference_numerics(dtype)
        ref = common.ref_on(self.cfg, dtype, self.sd, self.dev)
        first = ref_train.steps(ref, self.batches([0]), self.sched(), 1)
        p0 = self.sd
        upd1 = change_norms(first["params"], p0)
        res = ref_train.steps(ref, self.batches(range(1, CHECKED_STEPS)),
                              self.sched(), CHECKED_STEPS - 1, start=1,
                              adam=first["adam"])
        out = dict(losses=first["losses"] + res["losses"],
                   grad=checks.leaf_norms(first["grad"]),
                   update=change_norms(res["params"], p0),
                   ema=change_norms(res["ema"], p0), update1=upd1)
        del ref, res, first
        common.free(self.dev)
        return out

    def reference_replay(self, dtype: str, snap: dict) -> dict:
        """The reference's step ``REPLAYED`` in ``dtype`` from the state
        ``snap`` (on the host) on the replayed batch: its readings."""
        common.reference_numerics(dtype)
        dev = self.dev
        ref = common.ref_on(self.cfg, dtype, {
            k: v.to(dev) for k, v in snap["state"].items()}, dev)
        adam = {k: {n: v.to(dev, copy=True) for n, v in snap[k].items()}
                for k in ("m", "v", "ema")}
        res = ref_train.steps(ref, self.batches([REPLAYED]),
                              self.sched(), 1, start=REPLAYED, adam=adam)
        out = dict(losses=res["losses"],
                   grad=checks.leaf_norms(res["grad"]),
                   update=change_norms(res["params"], snap["state"]),
                   ema=change_norms(res["ema"], snap["ema"]))
        del ref, res, adam
        common.free(self.dev)
        return out

    def numbers(self, got: dict, got_replay: dict, dtype: str,
                snap: dict) -> dict:
        """The compared numbers of ``got`` (the first steps) and
        ``got_replay`` (the replay from ``snap``) against the reference
        in ``dtype``, with the report's lines."""
        ref = self.reference(dtype)
        ref_r = self.reference_replay(dtype, snap)
        numbers = checks.train_numbers(got, ref)
        numbers.update(checks.replay_numbers(got_replay, ref_r))
        self.report = getattr(self, "notes", []) + checks.train_report(
            got, ref) + checks.train_report(got_replay, ref_r, "replay ") + [
            f"reading {k} {v!r}" for k, v in numbers.items()]
        return numbers

    def check(self) -> list:
        self.release()
        numbers = self.numbers(self.got, self.got_replay,
                               self.cfg["model"]["dtype"], self.snap)
        return checks.hold(numbers, self.mix["limits"])

    def control(self) -> dict:
        """The control's numbers: the reference in the precision below the
        configuration's, in the program's place; for the replayed step,
        from the state the reference in the configuration's precision
        holds after as many steps as the program's before it."""
        self.inputs()
        dtype = self.cfg["model"]["dtype"]
        common.reference_numerics(dtype)
        ref = common.ref_on(self.cfg, dtype, self.sd, self.dev)
        res = ref_train.steps(ref, self.batches(range(REPLAYED)),
                              self.sched(), REPLAYED)
        snap = dict(state=host(res["state"]),
                    **{k: host(v) for k, v in res["adam"].items()})
        del ref, res
        common.free(self.dev)
        low = self.cfg["control_dtype"]
        got = self.reference(low)
        got_replay = self.reference_replay(low, snap)
        return self.numbers(got, got_replay, dtype, snap)
