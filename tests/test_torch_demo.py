"""The port's demo and playback CLIs on the CPU: ``tools/demo.py`` over a
stream written by ``data/psee_io.py:write_dat_events`` (each frame's
detections equal an eager ``StreamingDetector``'s, the backgrounds the
JAX package's ``event_frame_to_image(micro_sum(...))``, the PNGs JAX's
drawing outside the labels) and ``tools/play_events.py`` against the JAX
tool (``tools/play_events.py``, loaded by path): the binary histogram,
the tiles outside the labels, the HSV colour table against cv2's, the
frame counts, and the refusal of an mp4.
"""

import importlib.util
import os

import cv2
import numpy as np
import pytest
import torch

from eas_snn_tpu.data import EventStream as JEventStream
from eas_snn_tpu.data.reps import micro_sum as j_micro_sum
from eas_snn_tpu.utils import visualize as j_visualize

from chip_smoke import calibrate_spiking_bn
from eas_snn_tpu_torch.core.checkpoint import load_eval_weights
from eas_snn_tpu_torch.data import EVENT_DTYPE
from eas_snn_tpu_torch.data.psee_io import write_bboxes_npy, write_dat_events
from eas_snn_tpu_torch.exp.build import get_exp
from eas_snn_tpu_torch.inference import StreamingDetector
from eas_snn_tpu_torch.models.build import zoo_path
from eas_snn_tpu_torch.tools import demo, play_events
from eas_snn_tpu_torch.utils import draw, png

from test_torch_visualize import label_mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENSOR = (48, 64)
OPTS = ["width", "0.125", "depth", "0.33", "test_size", "(32, 64)",
        "compute_dtype", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _stream(path, seed, duration_us=1_000_000, rate=20_000):
    """A .dat stream on the 48x64 sensor: Poisson-timed events, a blob
    that drifts right, so that windows differ."""
    rng = np.random.default_rng(seed)
    n = duration_us * rate // 1_000_000
    t = np.sort(rng.integers(0, duration_us, n))
    x = (rng.integers(0, 24, n) + t * 40 // duration_us) % SENSOR[1]
    y = rng.integers(0, SENSOR[0], n)
    p = rng.integers(0, 2, n)
    write_dat_events(path, t, x, y, p, height=SENSOR[0], width=SENSOR[1])
    return path


# ------------------------------------------------------------------ demo

def _detector(exp, ckpt, conf):
    model = exp.get_model(device="cpu", seed=exp.seed or 0)
    load_eval_weights(model, ckpt)
    return StreamingDetector(
        model, img_size=SENSOR, input_size=exp.test_size, Tm=exp.Tm,
        window_us=abs(exp.window) * 1000, num_classes=exp.num_classes,
        confthre=conf, nmsthre=exp.nmsthre, device="cpu", eager=True)


@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    """The demo over 5 ticks with calibrated random weights through -c, at
    the fifth-highest score of the third tick's window (so that boxes are
    drawn)."""
    root = tmp_path_factory.mktemp("demo")
    dat = _stream(str(root / "seq_td.dat"), 0)
    exp = get_exp("gen1_syolox_s")
    exp.merge(OPTS)
    model = exp.get_model(device="cpu", seed=exp.seed or 0)
    with torch.no_grad():
        calibrate_spiking_bn(model, torch.poisson(torch.full(
            (2, 1, exp.Tm) + tuple(exp.test_size) + (2,), 0.2),
            generator=torch.Generator().manual_seed(0)))
    ckpt = str(root / "calibrated.pth")
    torch.save(model.state_dict(), ckpt)
    probe = _detector(exp, ckpt, 1.0)
    probe.push(JEventStream(dat).events_between(0, 400_000)
               .astype(EVENT_DTYPE))
    out = probe.outputs(400_000)[0]
    conf = float(np.sort(out[:, 4] * out[:, 5:].max(1))[-5])
    res = demo.main(["-n", "gen1_syolox_s", "--device", "cpu", "-c", ckpt,
                     "--input", dat, "--out", str(root / "frames"), "--fps",
                     "10", "--conf", repr(conf), "--max-frames", "5"]
                    + OPTS)
    return dat, ckpt, conf, res


def test_demo_detections_equal_streaming_detector(demo_run):
    dat, ckpt, conf, res = demo_run
    assert res["frames"] == 5 and res["device"] == "cpu"
    assert res["boxes_per_frame"][2] >= 1
    assert set(res["ms"]) == {"detect", "draw", "write"}
    exp = get_exp("gen1_syolox_s")
    exp.merge(OPTS)
    det = _detector(exp, ckpt, conf)
    stream = JEventStream(dat)
    t = stream.first_time() + 200_000
    for want in res["detections"]:
        ev = stream.events_between(t - res["tick_us"], t)
        det.push(ev.astype(EVENT_DTYPE))
        got = det.detect(t)
        assert (got is None) == (want is None)
        if got is not None:
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        t += res["tick_us"]


def test_zoo_names_resolve_for_the_demo_and_eval_clis():
    assert zoo_path("syolox_s_gen1") == zoo_path("syolox-s-gen1") == \
        os.path.join(REPO, "checkpoints", "syolox_s_gen1_init.pth")
    assert os.path.isfile(zoo_path("syolox-s-gen1"))
    assert zoo_path("best.pth") == "best.pth"


def test_demo_frames_equal_jax_drawing(demo_run):
    """Backgrounds: JAX's event_frame_to_image(micro_sum(window, 1, H,
    W)[0]); the PNG equals JAX's vis_detections of the same detections
    outside the labels."""
    dat, _, conf, res = demo_run
    stream = JEventStream(dat)
    t = stream.first_time() + 200_000
    for path, dets in zip(res["paths"], res["detections"]):
        window = stream.events_between(t - 200_000, t)
        bg = j_visualize.event_frame_to_image(
            j_micro_sum(window, 1, *SENSOR)[0])
        img = png.read_png(path)
        assert img.shape == SENSOR + (3,)
        mask = np.zeros(SENSOR, bool)
        ref = bg
        if dets is not None:
            scores = dets[:, 4] * dets[:, 5]
            ref = j_visualize.vis_detections(bg, dets[:, :4], scores,
                                             dets[:, 6], conf=conf)
            mask = label_mask(img.shape, dets[:, :4], scores, dets[:, 6],
                              conf, ())
        assert np.array_equal(img[~mask], ref[~mask]), path
        assert np.array_equal(cv2.imread(path), img)
        t += res["tick_us"]


# ---------------------------------------------------------- play_events

@pytest.fixture(scope="module")
def jax_play():
    spec = importlib.util.spec_from_file_location(
        "jax_play_events", os.path.join(REPO, "tools", "play_events.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hsv_table_equals_cv2():
    ref = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_HSV).reshape(-1, 3)
    assert np.array_equal(play_events.HSV_COLORS, ref)


def test_make_binary_histo_equals_jax(jax_play):
    rng = np.random.default_rng(4)
    ev = np.zeros(500, EVENT_DTYPE)
    ev["x"], ev["y"] = rng.integers(0, 64, 500), rng.integers(0, 48, 500)
    ev["p"] = rng.integers(0, 2, 500)
    for events in (ev, ev[:0]):
        a = np.zeros((48, 64, 3), np.uint8)
        b = np.ones((48, 64, 3), np.uint8)
        jax_play.make_binary_histo(events, a, 64, 48)
        play_events.make_binary_histo(events, b, 64, 48)
        assert np.array_equal(a, b)


def test_play_files_equal_jax_outside_labels(tmp_path, jax_play):
    rng = np.random.default_rng(6)
    files, boxes = [], []
    for k in range(3):  # a 2 x 2 grid with one empty tile
        dat = _stream(str(tmp_path / f"s{k}_td.dat"), k + 1,
                      duration_us=400_000)
        rows = [(int(t), float(rng.uniform(-10, 60)),
                 float(rng.uniform(-10, 45)), float(rng.uniform(2, 30)),
                 float(rng.uniform(2, 25)), int(rng.integers(0, 9)), 0, 1.0)
                for t in rng.integers(0, 400_000, 12)]
        boxes.append(write_bboxes_npy(str(tmp_path / f"s{k}_bbox.npy"),
                                      rows))
        files.append(dat)
    n_ref = jax_play.play_files(files, delta_t=50_000, save_path=None,
                                frames_dir=str(tmp_path / "jax"))
    n = play_events.play_files(files, delta_t=50_000,
                               frames_dir=str(tmp_path / "port"))
    assert n == n_ref == 8
    labelmap = play_events.LABELMAP_LARGE  # a 48x64 sensor
    drawn = 0
    for i in range(n):
        t0 = i * 50_000
        name = f"f{i:06d}.png"
        ref = cv2.imread(str(tmp_path / "jax" / name))
        mine = png.read_png(str(tmp_path / "port" / name))
        assert mine.shape == ref.shape == (2 * 48, 2 * 64, 3)
        mask = np.zeros(mine.shape[:2], bool)
        for k, bx in enumerate(boxes):
            oy, ox = divmod(k, 2)
            tile = mask[oy * 48:(oy + 1) * 48, ox * 64:(ox + 1) * 64]
            sel = bx[(bx["t"] >= t0) & (bx["t"] < t0 + 50_000)]
            drawn += len(sel)
            for b in sel:
                x, y = int(b["x"]), max(int(b["y"]) - 2, 8)
                label = labelmap[int(b["class_id"]) % len(labelmap)]
                (tw, th), base = draw.text_size(label, 0.35)
                tile[max(y - th, 0):max(y + base + 1, 0),
                     max(x - 1, 0):max(x + tw, 0)] = True
        assert np.array_equal(mine[~mask], ref[~mask]), name
    assert drawn > 0


def test_play_events_refuses_mp4(tmp_path):
    dat = _stream(str(tmp_path / "s_td.dat"), 9, duration_us=100_000)
    with pytest.raises(ValueError, match="mp4 .*encoder"):
        play_events.main([dat, "--frames", str(tmp_path / "f"), "-t",
                          str(tmp_path / "x.mp4")])
    assert not os.path.exists(tmp_path / "f")
    with pytest.raises(SystemExit):  # --frames is required
        play_events.main([dat])
    assert play_events.main([dat, "--frames", str(tmp_path / "f"),
                             "-d", "25000"]) == 4
    assert len(os.listdir(tmp_path / "f")) == 4
