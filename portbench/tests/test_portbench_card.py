"""Tests that need a CUDA card (marked ``card``; each skips here, deciding
inside the test). Run them on a machine with a CUDA card:

    python -m pytest portbench/tests/test_portbench_card.py -q

* the control of each cell, at a size a test run holds: the reference in
  the precision below the configuration's, in the program's place, fails
  at least one of the cell's limits;
* the harness driven with the timed path broken underneath (a step that
  leaves the state unchanged, half of the batch left out, an answer
  altered where it is produced; in the train cells, replays that train on
  the captured batch or leave the EMA out of the graph) sees ``correct``
  come out false, and the unbroken path at the same size true.
"""

import os
import sys

import pytest
import torch

from harness import checks, spec

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, PORTBENCH)
import run as harness_run  # noqa: E402

SMALL = {
    "gen1_syolox_m.train_b64": dict(batch=8, pool=4),
    "e_yolox_m.train_b32": dict(batch=4, pool=4),
    "gen1_syolox_m.eval_b128": dict(batch=16, pool=2, calib_windows=8),
}
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def small_cell(cell, seed):
    bench = spec.load_benchmark()
    wl = spec.workload(bench, cell)
    cfg = spec.config(bench, wl["config"])
    mix = dict(spec.traffic(cell), **SMALL[cell])
    return spec.driver(mix["driver"]).Cell(cfg, mix, seed,
                                           torch.device("cuda", 0)), mix


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    need_card()
    c, mix = small_cell(cell, 2**32 + 17)
    readings = checks.hold(c.control(), mix["limits"])
    assert not checks.passed(readings), readings


def one_run(cell, seconds=2.0):
    args = harness_run.parse(["--workload", cell, "--seed", str(2**33 + 3),
                              "--seconds", str(seconds), "--trace", "0"])
    return harness_run.run(args, overrides=SMALL[cell])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    need_card()
    out = one_run(cell)
    assert out["correct"], out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", [c for c in CELLS if ".train" in c])
def test_state_left_unchanged_is_caught(cell, monkeypatch):
    need_card()
    import eas_snn_tpu_torch.exp.event_exp as ee

    build = ee.build_optimizer

    def frozen(*a, **k):
        opt = build(*a, **k)
        opt.step = lambda closure=None: None
        return opt
    monkeypatch.setattr(ee, "build_optimizer", frozen)
    assert not one_run(cell)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", [c for c in CELLS if ".train" in c])
def test_half_batch_is_caught(cell, monkeypatch):
    need_card()
    from eas_snn_tpu_torch.core.train_state import CapturedStep

    call = CapturedStep.__call__

    def half(self, events, targets, use_l1=False):
        n = events.shape[0] // 2
        return call(self, events[:n].contiguous(), targets[:n].contiguous(),
                    use_l1)
    monkeypatch.setattr(CapturedStep, "__call__", half)
    assert not one_run(cell)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", [c for c in CELLS if ".train" in c])
def test_stale_replay_inputs_are_caught(cell, monkeypatch):
    need_card()
    from eas_snn_tpu_torch.core.train_state import CapturedStep

    replay = CapturedStep._replay

    def stale(self, g, events, targets):
        if self.replays:  # the static inputs keep the capture's batch
            events, targets = g.events, g.targets
        return replay(self, g, events, targets)
    monkeypatch.setattr(CapturedStep, "_replay", stale)
    assert not one_run(cell)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", [c for c in CELLS if ".train" in c])
def test_ema_left_out_of_the_graph_is_caught(cell, monkeypatch):
    need_card()
    from eas_snn_tpu_torch.core.train_state import CapturedStep

    capture = CapturedStep._capture

    def no_ema(self, *a):
        ema, self.ema = self.ema, None
        try:
            return capture(self, *a)
        finally:
            self.ema = ema
    monkeypatch.setattr(CapturedStep, "_capture", no_ema)
    assert not one_run(cell)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", [c for c in CELLS if ".train" not in c])
def test_altered_answer_is_caught(cell, monkeypatch):
    need_card()
    from eas_snn_tpu_torch.models.head import YOLOXHead

    fwd = YOLOXHead.forward

    def altered(self, xin):
        out = fwd(self, xin)
        if not self.training:  # one anchor's objectness moved by 0.05
            out = out.clone()
            out[:, 0, 4] = (out[:, 0, 4] + 0.05).clamp(0, 1)
        return out
    monkeypatch.setattr(YOLOXHead, "forward", altered)
    assert not one_run(cell)["correct"]
