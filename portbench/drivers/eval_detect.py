"""Driver ``eval_detect``: the port's eval front door
(``exp/event_exp.py:detect``: the forward without gradients, the copy to
the host and the host NMS, ``ops/boxes.py:postprocess``) under
``deploy()``, at the mix's batch, over a pool of event batches made on
the card at set-up, at the preset's ``test_conf`` and ``nmsthre``.

Once the window has closed and the device's peak memory has been read,
one more call of the same ``detect`` on the same model, on a pool batch
drawn from the seed, records what every site of the forward received and
produced and what ``detect`` returned; the reference then holds it site
by site (``harness/sites.py``). The window itself carries no hook."""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import checks, common, sites, trace, traffic
from reference.nms import postprocess as ref_postprocess


class Cell:
    kind = "eval"

    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda"):
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, device
        self.B = mix["batch"]
        self.next = 0

    def inputs(self) -> None:
        from eas_snn_tpu_torch.exp.build import get_exp

        cfg, mix = self.cfg, self.mix
        exp = get_exp(cfg["preset"])
        self.conf, self.nms = exp.test_conf, exp.nmsthre
        sd = common.state(cfg, self.seed, self.dev)
        gen = torch.Generator(device=self.dev).manual_seed(
            traffic.seeded(self.seed, 3))
        calib = traffic.event_batch(mix, cfg["model"], mix["calib_windows"],
                                    gen, self.dev)
        self.sd = common.calibrated(cfg, sd, calib, self.dev)
        del sd, calib
        self.events = [traffic.event_batch(mix, cfg["model"], self.B, gen,
                                           self.dev)
                       for _ in range(mix["pool"])]
        rng = np.random.default_rng(traffic.seeded(self.seed, 5))
        self.recorded = int(rng.integers(0, mix["pool"]))

    def setup(self) -> None:
        from eas_snn_tpu_torch.exp.event_exp import detect

        self.inputs()
        exp = common.program_exp(self.cfg).deploy()
        model = exp.get_model(device=self.dev,
                              seed=traffic.seeded(self.seed, 2))
        model.load_state_dict(self.sd)
        self.model = model.eval()
        self.detect = lambda ev: detect(self.model, ev, self.conf, self.nms)
        for _ in range(self.mix["warmup"]):
            self.detect(self.events[0])
        common.sync(self.dev)

    def call(self) -> None:
        self.detect(self.events[self.next % len(self.events)])
        self.next += 1

    def record(self) -> tuple:
        """The recorded call: ``detect`` on the pool batch drawn from the
        seed, with every site's inputs and output, the decoded outputs and
        the detections kept."""
        cap = sites.Capture(self.model, armed=True)
        outs = []
        grab = self.model.register_forward_hook(
            lambda m, a, out: outs.append(out.detach().clone()))
        try:
            dets = self.detect(self.events[self.recorded])
        finally:
            grab.remove()
            cap.close()
        return cap.data, outs[0], dets

    def window(self, seconds: float) -> dict:
        common.sync(self.dev)
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self.call()
            n += 1
        dt = time.perf_counter() - t0
        return dict(attempted=n, failed=0, window_s=dt,
                    metrics={"eval_frames_per_s": n * self.B / dt})

    def traced(self, seconds: float) -> dict:
        from eas_snn_tpu_torch.ops.boxes import postprocess

        mods = {"sampler": self.model.embedding,
                "backbone": self.model.backbone.backbone,
                "pafpn": self.model.backbone, "head": self.model.head}
        marks = {k: [] for k in mods}
        handles = []
        for k, m in mods.items():
            def pre(mod, args, k=k):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks[k].append([e])

            def post(mod, args, out, k=k):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks[k][-1].append(e)
            handles += [m.register_forward_pre_hook(pre),
                        m.register_forward_hook(post)]
        n = self.mix["trace_units"]
        outs = []
        grab = self.model.register_forward_hook(
            lambda m, a, out: outs.append(out.detach().float()))
        try:
            with trace.traced() as tr:
                with trace.window():
                    for _ in range(n):
                        # names the device's idle gaps while the host
                        # filters and suppresses (numpy: no profiler op)
                        with torch.profiler.record_function("detect"):
                            self.call()
                    common.sync(self.dev)
        finally:
            for h in handles + [grab]:
                h.remove()
        ms = {k: float(np.mean([a.elapsed_time(b) for a, b in v]))
              for k, v in marks.items()}
        host = []
        for out in outs[:len(self.events)]:
            pred = out.cpu().numpy()
            t0 = time.perf_counter()
            postprocess(pred, self.model.head.num_classes, self.conf,
                        self.nms)
            host.append((time.perf_counter() - t0) * 1e3)
        layer_ms = {"sampler": ms["sampler"], "backbone": ms["backbone"],
                    "neck_head": ms["pafpn"] - ms["backbone"] + ms["head"]}
        return dict(attempted=n, failed=0, trace=tr, units=n, batch=self.B,
                    kind=self.kind, cfg=self.cfg, mix=self.mix,
                    layer_ms=layer_ms, postprocess_ms=float(np.mean(host)))

    # ------------------------------------------------------------ check
    def release(self) -> None:
        del self.model, self.detect
        common.free(self.dev)

    def held(self, cap: dict, out: torch.Tensor, dets) -> dict:
        """The site-by-site numbers of a recorded call (``cap``, its
        decoded ``out`` and detections ``dets``) against the reference in
        the configuration's precision."""
        common.reference_numerics(self.cfg["model"]["dtype"])
        ref = common.ref_on(self.cfg, self.cfg["model"]["dtype"], self.sd,
                            self.dev).eval()
        numbers = sites.teacher_forced(
            ref, cap, self.events[self.recorded], out,
            checks.anchor_strides(self.cfg["model"]))
        pred = out.float().cpu().numpy()
        numbers["dets_gap"] = sites.dets_gap(
            dets, ref_postprocess(pred, ref.num_classes, self.conf, self.nms))
        del ref
        common.free(self.dev)
        return numbers

    def check(self) -> list:
        kept = self.record()
        self.release()
        numbers = self.held(*kept)
        self.report = [f"reading {k} {v!r}" for k, v in numbers.items()]
        return checks.hold(numbers, self.mix["limits"])

    def control(self) -> dict:
        """The reference in the control's precision, in the program's
        place, recorded as a timed call is, then held as a run holds the
        program."""
        self.inputs()
        dtype = self.cfg["control_dtype"]
        common.reference_numerics(dtype)
        low = common.ref_on(self.cfg, dtype, self.sd, self.dev).eval()
        cap = sites.Capture(low, armed=True)
        with torch.no_grad():
            out = low(self.events[self.recorded]).float()
        cap.close()
        dets = ref_postprocess(out.cpu().numpy(), low.num_classes,
                               self.conf, self.nms)
        del low
        common.free(self.dev)
        return self.held(cap.data, out, dets)
