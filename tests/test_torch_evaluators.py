"""The port's evaluators against the JAX package's on the CPU: the COCO
engine (native and numpy matchers), VOC AP, the Prophesee protocol's
filters and matching, both event evaluators over one synthetic Gen1 tree,
the native matcher's build, and the row gather across two gloo
processes. Every comparison is exact (``==``): the port's numpy is a copy
of the JAX package's, in float64, in the same order of operations.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from eas_snn_tpu.data import EventDataLoader as JLoader
from eas_snn_tpu.data import Gen1Dataset as JGen1
from eas_snn_tpu.evaluators import coco_map as jcoco
from eas_snn_tpu.evaluators import event_evaluator as jev
from eas_snn_tpu.evaluators import prophesee as jpro
from eas_snn_tpu.evaluators import voc_eval as jvoc

from eas_snn_tpu_torch.data import EventDataLoader as PLoader
from eas_snn_tpu_torch.data import Gen1Dataset as PGen1
from eas_snn_tpu_torch.evaluators import coco_map as pcoco
from eas_snn_tpu_torch.evaluators import cocoeval as pnative
from eas_snn_tpu_torch.evaluators import event_evaluator as pev
from eas_snn_tpu_torch.evaluators import prophesee as ppro
from eas_snn_tpu_torch.evaluators import voc_eval as pvoc
from eas_snn_tpu_torch.ops import _build as pbuild

from eas_snn_tpu_torch.tools.ap_drift import make_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(seed, n_img=6, n_cls=3, n_gt=60, n_junk=80, ties=True):
    """Ground truth (with ~10% ignored) and detections: jittered copies of
    the ground truth plus junk boxes, areas across small / medium /
    large, scores on a coarse grid (ties) or continuous."""
    rng = np.random.default_rng(seed)
    gt = np.c_[rng.integers(0, n_img, n_gt), rng.integers(0, n_cls, n_gt),
               rng.uniform(0, 300, (n_gt, 2)), rng.uniform(5, 150, (n_gt, 2)),
               rng.random(n_gt) < 0.1]

    def score(n):
        return rng.integers(0, 5, n) / 5 if ties else rng.random(n)

    det = np.c_[gt[:, :2], gt[:, 2:6] * rng.uniform(0.8, 1.2, (n_gt, 4)),
                score(n_gt)]
    junk = np.c_[rng.integers(0, n_img, n_junk),
                 rng.integers(0, n_cls, n_junk),
                 rng.uniform(0, 300, (n_junk, 2)),
                 rng.uniform(5, 150, (n_junk, 2)), score(n_junk)]
    return np.r_[det, junk], gt


def _assert_results_equal(a, b):
    np.testing.assert_array_equal(a.stats, b.stats)
    for k in ("per_class_ap", "per_class_ar"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.keys() == y.keys()
        np.testing.assert_array_equal([x[c] for c in x], [y[c] for c in y])


# -------------------------------------------------------------- COCO mAP

@pytest.mark.parametrize("seed,ties", [(0, True), (1, True), (2, False),
                                       (3, False), (4, True)])
def test_det_eval_equals_jax_native_and_numpy(seed, ties):
    det, gt = _rows(seed, ties=ties)
    runs = [mod.DetEval(3, use_native=native).evaluate(det, gt)
            for mod in (jcoco, pcoco) for native in (True, False)]
    assert 0.0 < runs[0].ap < 1.0
    for r in runs[1:]:
        _assert_results_equal(r, runs[0])
    names = ("car", "pedestrian", "cyclist")
    text = jcoco.summarize(runs[0], names)
    assert all(pcoco.summarize(r, names) == text for r in runs[1:])


def test_det_eval_edge_cases_equal_jax():
    """No detections, no ground truth, a category with ground truth
    only, and 6-column ground truth."""
    det, gt = _rows(5)
    cases = [(np.zeros((0, 7)), gt), (det, np.zeros((0, 7))),
             (det[det[:, 1] != 2], gt[:, :6])]
    for d, g in cases:
        for native in (True, False):
            _assert_results_equal(
                pcoco.DetEval(3, use_native=native).evaluate(d, g),
                jcoco.DetEval(3, use_native=native).evaluate(d, g))
    for name in ("IOU_THRS", "RECALL_THRS", "AREA_RNGS", "MAX_DETS"):
        assert np.array_equal(getattr(pcoco, name), getattr(jcoco, name)) \
            if name.endswith("THRS") else \
            getattr(pcoco, name) == getattr(jcoco, name)


def test_native_matcher_builds_into_the_port_and_raises_on_failure(
        tmp_path, monkeypatch):
    lib = pnative.load_native()
    path = lib._name
    assert os.path.dirname(path) == os.path.join(REPO, "eas_snn_tpu_torch",
                                                 "_build")
    assert os.path.basename(path).startswith("libcocoeval_")
    assert os.path.exists(path) and lib.coco_match_category
    assert pnative.load_native() is lib  # built and bound once
    bad = tmp_path / "cocoeval.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "_SRC", str(bad))
    monkeypatch.setattr(pbuild, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pnative.load_native()
    assert os.listdir(tmp_path / "build") == []  # no half-written library


# ------------------------------------------------------------------- VOC

@pytest.mark.parametrize("use07", [False, True])
def test_voc_equals_jax(use07):
    rng = np.random.default_rng(3)
    det, gt = _rows(6)
    xyxy = lambda r: np.c_[r[:, :2], r[:, 2:4], r[:, 2:4] + r[:, 4:6],
                           r[:, 6:]]
    det, gt = xyxy(det), xyxy(gt)
    got = pvoc.VOCDetEval(3, use_07_metric=use07).evaluate(det, gt)
    want = jvoc.VOCDetEval(3, use_07_metric=use07).evaluate(det, gt)
    assert got == want and 0.0 < got[0] < 1.0
    rec = np.sort(rng.random(20))
    prec = rng.random(20)
    assert pvoc.voc_ap(rec, prec, use07) == jvoc.voc_ap(rec, prec, use07)
    by_img = {i: (gt[gt[:, 0] == i][:, 2:6], gt[gt[:, 0] == i][:, 6] > 0)
              for i in range(6)}
    d0 = det[det[:, 1] == 0]
    args = (by_img, d0[:, 0].astype(int), d0[:, 2:6], d0[:, 6])
    for a, b in zip(pvoc.voc_eval_class(*args, use_07_metric=use07),
                    jvoc.voc_eval_class(*args, use_07_metric=use07)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- Prophesee

def _psee_boxes(rng, n, t_max=2_000_000):
    """Ground truth on a 50 ms clock, and detections: jittered copies of
    it (within +-60 ms) beside as many junk boxes, with seeded scores."""
    t = rng.integers(0, t_max, n) // 50_000 * 50_000
    x, y = rng.uniform(0, 250, n), rng.uniform(0, 200, n)
    w, h = rng.uniform(4, 90, n), rng.uniform(4, 70, n)
    c = rng.integers(0, 2, n)
    gt = ppro.boxes_to_prophesee(t, x, y, w, h, c, np.ones(n, np.float32))
    jit = rng.uniform(0.9, 1.1, (4, n))
    dt = ppro.boxes_to_prophesee(
        np.r_[np.maximum(t + rng.integers(-60_000, 60_000, n), 0),
              rng.integers(0, t_max, n)],
        np.r_[x * jit[0], rng.uniform(0, 250, n)],
        np.r_[y * jit[1], rng.uniform(0, 200, n)],
        np.r_[w * jit[2], rng.uniform(4, 90, n)],
        np.r_[h * jit[3], rng.uniform(4, 70, n)],
        np.r_[c, rng.integers(0, 2, n)],
        rng.random(2 * n).astype(np.float32))
    return gt, dt


def test_prophesee_filters_and_matching_equal_jax():
    rng = np.random.default_rng(4)
    gt, dt = _psee_boxes(rng, 150)
    assert ppro.BBOX_DTYPE == jpro.BBOX_DTYPE
    for diag, side in ((30, 10), (60, 20), (15, 5)):
        np.testing.assert_array_equal(
            ppro.filter_boxes(gt, int(5e5), diag, side),
            jpro.filter_boxes(gt, int(5e5), diag, side))
    ts = np.unique(gt["t"])
    for tol in (0, 50_000, 120_000):
        for got, want in zip(ppro.match_times(ts, gt, dt, tol),
                             jpro.match_times(ts, gt, dt, tol)):
            assert len(got) == len(want) == len(ts)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    args = ([dt, dt[::2]], [gt, gt[1::2]])
    for kw in (dict(camera="gen1"), dict(camera="gen4"),
               dict(camera="gen1", downsampled_by_2=True),
               dict(camera="gen1", apply_bbox_filters=False),
               dict(camera="gen1", use_native=False)):
        got = ppro.evaluate_lists(*args, **kw)
        want = jpro.evaluate_lists(*args, **kw)
        got_pc, want_pc = got.pop("per_class_AP"), want.pop("per_class_AP")
        assert got == want, kw
        assert got_pc.keys() == want_pc.keys()
        np.testing.assert_array_equal(list(got_pc.values()),
                                      list(want_pc.values()))  # NaN == NaN
    assert 0.0 < got["AP"] < 1.0


# ------------------------------------------------------- event evaluators

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A Gen1 val tree of the AP-drift writer (2 streams of 3 s, a label
    group every 0.5 s from 0.3 s: past the protocol's first 0.5 s, and
    further apart than its +-50 ms)."""
    root = str(tmp_path_factory.mktemp("gen1_eval"))
    make_data(root, n_train=0, n_val=2, duration_us=3_000_000)
    return os.path.join(root, "val")


_DS = dict(input_size=(64, 80), training=False, map_val=True,
           aggregation="sum", num_slice=1, micro_slice=1,
           window=(-100_000, 0))


def _loaders(root, batch=4):
    jds, pds = JGen1(root, **_DS), PGen1(root, **_DS)
    return (JLoader(jds, batch_size=batch, shuffle=False, infinite=False,
                    num_workers=1),
            PLoader(pds, batch_size=batch, shuffle=False, infinite=False,
                    num_workers=0))


def _noisy_forward(ds, num_classes, truth_only=False):
    """A forward_fn (batches in the loaders' sequential order) emitting
    jittered ground-truth boxes with seeded scores and junk boxes, as
    float32 (B, A, 5 + C); with ``truth_only`` the exact ground truth."""
    scale = min(_DS["input_size"][0] / 240, _DS["input_size"][1] / 304)
    state = {"next": 0, "rng": np.random.default_rng(11)}

    def forward(frames):
        rng = state["rng"]
        B = frames.shape[0]
        out = np.zeros((B, 24, 5 + num_classes), np.float32)
        out[:, :, :2] = rng.uniform(0, 80, (B, 24, 2))
        out[:, :, 2:4] = rng.uniform(2, 40, (B, 24, 2))
        out[:, :, 4:] = 0.0 if truth_only else rng.random(
            (B, 24, 1 + num_classes))
        for b in range(B):
            raw = ds.raw_boxes(*ds.resolve_index(state["next"] + b))
            for j, (x1, y1, x2, y2, cls) in enumerate(raw):
                jit = 1.0 if truth_only else rng.uniform(0.9, 1.1, 4)
                out[b, j, :4] = np.array([(x1 + x2) / 2, (y1 + y2) / 2,
                                          x2 - x1, y2 - y1]) * scale * jit
                out[b, j, 4] = 0.99 if truth_only else rng.uniform(0.3, 1)
                out[b, j, 5:] = 0.0
                out[b, j, 5 + int(cls)] = 0.99
        state["next"] += B
        return out

    return forward


def _without_timing(text):
    return "\n".join(r for r in text.splitlines()
                     if not r.lstrip().startswith("forward:"))


@pytest.mark.parametrize("proph", [False, True])
@pytest.mark.parametrize("truth_only", [False, True])
def test_event_evaluators_equal_jax(tree, proph, truth_only):
    """Both packages' map_val loaders over one tree, the same forward_fn
    outputs: equal AP, AP50 and text (the timing line aside); the ground
    truth as predictions gives 1.0."""
    jl, pl = _loaders(tree)
    kw = dict(img_size=_DS["input_size"], confthre=0.001 if proph else 0.01,
              nmsthre=0.65, num_classes=2)
    if proph:
        jeval = jev.PSEEEvaluator(jl, camera="gen1", **kw)
        peval = pev.PSEEEvaluator(pl, camera="gen1", **kw)
    else:
        jeval, peval = jev.EventEvaluator(jl, **kw), pev.EventEvaluator(pl,
                                                                         **kw)
    want = jeval.evaluate(_noisy_forward(jl.dataset, 2, truth_only))
    got = peval.evaluate(_noisy_forward(pl.dataset, 2, truth_only))
    assert got[:2] == want[:2]
    assert _without_timing(got[2]) == _without_timing(want[2])
    if truth_only:
        assert got[:2] == (1.0, 1.0)
    else:
        assert 0.0 < got[0] < 1.0
    tm = peval.timing
    assert tm["samples"] == len(pl.dataset)
    assert all(tm[k] >= 0 for k in ("data_s", "forward_s", "nms_s",
                                    "match_s"))
    assert tm["wall_s"] >= tm["forward_s"] + tm["nms_s"]


# ----------------------------------------------------------- row gather

_GATHER = """
import sys
import numpy as np
import torch.distributed as dist
from eas_snn_tpu_torch.evaluators.event_evaluator import _allgather_rows
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
rows = np.random.default_rng(rank).random((3 + 4 * rank, 8))
got = _allgather_rows(rows)
empty = _allgather_rows(np.zeros((0, 7)) if rank == 0
                        else np.ones((2, 7)))
if rank == 0:
    np.savez(out, got=got, empty=empty)
dist.destroy_process_group()
print("done", rank)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_allgather_rows_across_two_gloo_processes(tmp_path):
    rows = np.arange(14.0).reshape(2, 7)
    assert pev._allgather_rows(rows) is rows  # no process group: identity
    out = str(tmp_path / "gathered.npz")
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _GATHER, str(r), "2",
                               port, out], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        results = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, results):
        assert p.returncode == 0, e[-3000:]
    res = np.load(out)
    want = np.concatenate([np.random.default_rng(r).random((3 + 4 * r, 8))
                           for r in range(2)])
    np.testing.assert_array_equal(res["got"], want)
    np.testing.assert_array_equal(res["empty"], np.ones((2, 7)))
