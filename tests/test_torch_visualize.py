"""The port's drawing surface on the CPU against cv2 and the JAX package:
the PNG writer and reader against ``cv2.imread`` / ``cv2.imwrite``, the
raster primitives (``utils/draw.py``) bit for bit against cv2's, the
label footprints against ``cv2.getTextSize``, ``event_frame_to_image``
and ``vis_detections`` against the JAX package's (equal outside the
labels, whose glyphs differ by design), ``visualize_assignments`` against
JAX's (assignments and images bit-equal), the tracker's prediction images
and artifacts, and the trainer's prediction images after an evaluation.
"""

import os
import struct
import sys
import types
import zlib

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eas_snn_tpu.models import EASYOLOX as JEASYOLOX
from eas_snn_tpu.models.simota import simota_assign as j_simota_assign
from eas_snn_tpu.utils import assign_viz as j_assign_viz
from eas_snn_tpu.utils import tracking as j_tracking
from eas_snn_tpu.utils import visualize as j_visualize

from eas_snn_tpu_torch.models import EASYOLOX
from eas_snn_tpu_torch.utils import draw, png, state_dict_from_jax
from eas_snn_tpu_torch.utils import visualize
from eas_snn_tpu_torch.utils.assign_viz import assign, visualize_assignments
from eas_snn_tpu_torch.utils.tracking import MetricsTracker

from test_torch_model import _random_variables

FONT = cv2.FONT_HERSHEY_SIMPLEX
PRINTABLE = [chr(c) for c in range(32, 127)]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def label_mask(shape, boxes, scores, ids, conf, names):
    """Where ``vis_detections`` may draw a label: each drawn box's filled
    label box and its text's footprint (cv2's antialiased glyphs reach
    one column left of the origin)."""
    mask = np.zeros(shape[:2], bool)

    def put(x0, y0, x1, y1):
        mask[max(y0, 0):max(y1 + 1, 0), max(x0, 0):max(x1 + 1, 0)] = True

    for b, s, c in zip(boxes, scores, ids):
        if s < conf:
            continue
        x1, y1 = int(b[0]), int(b[1])
        label = visualize.label_text(float(s), int(c), names)
        (tw, th), base = draw.text_size(label, visualize.LABEL_SCALE)
        put(x1, y1 - th - 4, x1 + tw, y1)
        put(x1 - 1, y1 - 2 - th, x1 + tw - 1, y1 - 2 + base)
    return mask


# ------------------------------------------------------------------ PNG

@pytest.mark.parametrize("shape", [(1, 1, 3), (24, 31, 3), (240, 304, 3),
                                   (17, 23)])
def test_png_round_trip_through_cv2(tmp_path, shape):
    img = np.random.default_rng(len(shape) + shape[0]).integers(
        0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    png.write_png(path, img)
    flag = cv2.IMREAD_UNCHANGED if len(shape) == 2 else cv2.IMREAD_COLOR
    ref = cv2.imread(path, flag)
    assert ref.shape == img.shape and np.array_equal(ref, img)
    mine = png.read_png(path)
    assert mine.dtype == np.uint8 and np.array_equal(mine, ref)
    mine[...] = 0  # a writable copy, not a view of the file's bytes


def test_png_reader_refuses_bad_files(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (8, 9, 3)).astype(
        np.uint8)
    path = str(tmp_path / "a.png")
    png.write_png(path, img)
    buf = bytearray(open(path, "rb").read())
    bad = bytearray(buf)
    bad[-13] ^= 1  # the last byte of the IDAT chunk's CRC
    open(str(tmp_path / "crc.png"), "wb").write(bad)
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(str(tmp_path / "crc.png"))
    open(str(tmp_path / "cut.png"), "wb").write(buf[:40])
    with pytest.raises(ValueError, match="truncated"):
        png.read_png(str(tmp_path / "cut.png"))
    cv2.imwrite(str(tmp_path / "deep.png"), np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(str(tmp_path / "deep.png"))
    # the same file with the interlace byte of IHDR set (CRC made good)
    ihdr = bytes(buf[12:29])
    laced = ihdr[:-1] + b"\x01"
    buf[12:33] = laced + struct.pack(">I", zlib.crc32(laced))
    open(str(tmp_path / "laced.png"), "wb").write(buf)
    with pytest.raises(ValueError, match="interlace 1"):
        png.read_png(str(tmp_path / "laced.png"))
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(path, img.astype(np.float32))
    # a row under filter 1 (Sub), which write_png never writes
    raw = np.zeros((8, 1 + 9 * 3), np.uint8)
    raw[1, 0] = 1

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    open(str(tmp_path / "sub.png"), "wb").write(
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr[4:])
        + chunk(b"IDAT", zlib.compress(raw.tobytes()))
        + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=r"row filters \[0, 1\]"):
        png.read_png(str(tmp_path / "sub.png"))


# ----------------------------------------------------------- primitives

@pytest.mark.parametrize("thickness", [1, 2, -1])
def test_rectangle_equals_cv2(thickness):
    """Random boxes on random images, partly or wholly off the image,
    far off it, reversed, zero-width and zero-height."""
    rng = np.random.default_rng(thickness + 7)
    for n in range(600):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        if n % 6 == 0:
            p = rng.integers(-100_000, 100_000, 4)
        else:
            p = rng.integers(-10, 50, 4)
        if n % 5 == 1:
            p[2] = p[0]
        if n % 7 == 2:
            p[3] = p[1]
        p = [int(v) for v in p]
        grey = n % 4 == 3
        shape = (h, w) if grey else (h, w, 3)
        ref = rng.integers(0, 256, shape).astype(np.uint8)
        mine = ref.copy()
        color = (int(rng.integers(256)) if grey else
                 tuple(int(c) for c in rng.integers(0, 256, 3)))
        cv2.rectangle(ref, (p[0], p[1]), (p[2], p[3]), color, thickness)
        draw.rectangle(mine, (p[0], p[1]), (p[2], p[3]), color, thickness)
        assert np.array_equal(ref, mine), (shape, p, thickness)


def test_rectangle_thickness_2_cuts_the_outer_corners():
    img = np.zeros((14, 14), np.uint8)
    draw.rectangle(img, (3, 4), (10, 9), 255, 2)
    ys, xs = np.nonzero(img)
    assert (ys.min(), ys.max(), xs.min(), xs.max()) == (3, 10, 2, 11)
    assert not img[6:8, 5:9].any()
    assert all(img[y, x] == 0 for x, y in ((2, 3), (11, 3), (2, 10),
                                           (11, 10)))
    with pytest.raises(ValueError, match="thickness 3"):
        draw.rectangle(img, (0, 0), (4, 4), 1, 3)


@pytest.mark.parametrize("radius", [1, 2, 5])
def test_circle_equals_cv2_at_the_edges(radius):
    rng = np.random.default_rng(radius)
    for h, w in ((1, 1), (3, 4), (9, 7), (20, 31)):
        for cx in range(-radius - 1, w + radius + 1):
            for cy in (-radius - 1, -1, 0, h // 2, h - 1, h + radius):
                ref = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
                mine = ref.copy()
                cv2.circle(ref, (cx, cy), radius, (9, 99, 199), -1)
                draw.circle(mine, (cx, cy), radius, (9, 99, 199))
                assert np.array_equal(ref, mine), (h, w, cx, cy)


@pytest.mark.parametrize("scale", [0.4, 0.35])
def test_text_size_equals_cv2(scale):
    rng = np.random.default_rng(int(scale * 100))
    labels = PRINTABLE + ["", "car:90.0%", "pedestrian:100.0%",
                          "traffic light", "two wheeler"]
    labels += ["".join(rng.choice(PRINTABLE, int(rng.integers(1, 30))))
               for _ in range(200)]
    for label in labels:
        assert draw.text_size(label, scale) == cv2.getTextSize(
            label, FONT, scale, 1), repr(label)
    with pytest.raises(ValueError, match="scale 0.5"):
        draw.text_size("a", 0.5)


@pytest.mark.parametrize("scale", [0.4, 0.35])
def test_put_text_stays_in_the_footprint(scale):
    rng = np.random.default_rng(5)
    for label in PRINTABLE + ["car:90.0%", "pedestrian", "Wg|j(Q)_~"]:
        img = np.zeros((60, 200, 3), np.uint8)
        draw.put_text(img, label, (20, 30), scale, (255, 255, 255))
        (tw, th), base = draw.text_size(label, scale)
        inside = np.zeros(img.shape[:2], bool)
        inside[30 - th:30 + base + 1, 20:20 + tw] = True
        assert not img[~inside].any(), repr(label)
        assert label.strip() == "" or img.any(), repr(label)
        assert set(np.unique(img)) <= {0, 255}
    # clipped at the image's edges
    img = np.zeros((5, 6), np.uint8)
    x, y = (int(v) for v in rng.integers(-5, 5, 2))
    draw.put_text(img, "AbC", (x, y), scale, 200)


# ------------------------------------------------------------ visualize

@pytest.mark.parametrize("kind", ["float", "int"])
def test_event_frame_to_image_equals_jax(kind):
    rng = np.random.default_rng(1)
    frame = (rng.normal(0, 1, (37, 53, 2)).astype(np.float32)
             if kind == "float"
             else rng.integers(0, 3, (37, 53, 2)).astype(np.int32))
    ref = j_visualize.event_frame_to_image(frame)
    mine = visualize.event_frame_to_image(frame)
    assert mine.dtype == np.uint8 and np.array_equal(ref, mine)


def _detections(rng, n, h, w, ids_max=25):
    x1 = rng.uniform(-20, w, n)
    y1 = rng.uniform(-20, h, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(0, 60, n),
                      y1 + rng.uniform(0, 50, n)], 1).astype(np.float32)
    return (boxes, rng.uniform(0, 1, n).astype(np.float32),
            rng.integers(0, ids_max, n))


def test_vis_detections_equals_jax_outside_the_labels():
    """Scores below conf, ids past the names and past the palette, boxes
    off the image: every pixel outside the labels is JAX's."""
    rng = np.random.default_rng(2)
    names = ("car", "pedestrian")
    for trial in range(20):
        img = visualize.event_frame_to_image(
            rng.integers(0, 3, (96, 128, 2)))
        boxes, scores, ids = _detections(rng, 8, 96, 128)
        ref = j_visualize.vis_detections(img, boxes, scores, ids, conf=0.3,
                                         class_names=names)
        mine = visualize.vis_detections(img, boxes, scores, ids, conf=0.3,
                                        class_names=names)
        mask = label_mask(img.shape, boxes, scores, ids, 0.3, names)
        assert not np.array_equal(ref, img)
        assert np.array_equal(ref[~mask], mine[~mask]), trial
    # no scores, no ids: every box drawn as class 0
    boxes = boxes[:3]
    ref = j_visualize.vis_detections(img, boxes)
    mine = visualize.vis_detections(img, boxes)
    mask = label_mask(img.shape, boxes, np.ones(3), np.zeros(3), 0.5, ())
    assert np.array_equal(ref[~mask], mine[~mask])


def test_vis_detections_labels_hold_fill_and_white():
    img = np.full((120, 240, 3), 127, np.uint8)
    boxes = np.array([[10, 30, 60, 70], [120, 40, 200, 100],
                      [20, 90, 90, 118]], np.float32)
    scores = np.array([0.9, 0.55, 0.7], np.float32)
    ids = np.array([0, 1, 23])
    mine = visualize.vis_detections(img, boxes, scores, ids, conf=0.3,
                                    class_names=("car", "pedestrian"))
    for b, s, c in zip(boxes, scores, ids):
        x1, y1 = int(b[0]), int(b[1])
        label = visualize.label_text(float(s), int(c), ("car", "pedestrian"))
        (tw, th), _ = draw.text_size(label, visualize.LABEL_SCALE)
        box = mine[y1 - th - 4:y1 + 1, x1:x1 + tw + 1].reshape(-1, 3)
        color = tuple(int(v) for v in visualize._PALETTE[c % 20])
        seen = {tuple(int(v) for v in p) for p in np.unique(box, axis=0)}
        assert seen == {color, (255, 255, 255)}, (label, seen)


# ------------------------------------------------------ assignment view

@pytest.fixture(scope="module")
def assign_case():
    """The JAX package's own case (tests/test_utils.py:199-222): depth
    0.33, width 0.125, count embedding, 64x64, B=2 (a third box added);
    weights drawn with numpy at the JAX init's shapes (the JAX init takes
    ~30 s here) into both models."""
    m = JEASYOLOX(num_classes=2, depth=0.33, width=0.125, use_spike="none",
                  embedding="count")
    rng = np.random.default_rng(5)
    events = rng.poisson(0.3, (2, 1, 1, 64, 64, 2)).astype(np.float32)
    labels = np.zeros((2, 5, 5), np.float32)
    labels[0, 0] = [0, 32, 32, 20, 16]
    labels[1, 0] = [1, 16, 40, 12, 12]
    labels[1, 1] = [0, 44, 20, 16, 24]
    v = _random_variables(m, events, rng)
    pm = EASYOLOX(num_classes=2, depth=0.33, width=0.125, use_spike="none",
                  embedding="count")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return m, v, pm.eval(), events, labels


def test_assignments_equal_jax(assign_case):
    m, v, pm, events, labels = assign_case
    head_out, _ = m.apply(v, jnp.asarray(events), None, train=True,
                          mutable=["batch_stats"])
    outputs = np.asarray(head_out)
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    res, (gx, gy, sv) = assign(pm, torch.from_numpy(events), labels)
    assert not pm.training
    assert all(torch.equal(before[k], t) for k, t in pm.state_dict().items())
    for b in range(len(events)):
        lab = labels[b]
        j = j_simota_assign(
            jnp.asarray(lab[:, 1:5]), jnp.asarray(lab[:, 0]),
            jnp.asarray(lab.sum(-1) > 0), jnp.asarray(outputs[b, :, :4]),
            jnp.asarray(outputs[b, :, 5:]), jnp.asarray(outputs[b, :, 4]),
            jnp.asarray((gx + 0.5) * sv), jnp.asarray((gy + 0.5) * sv),
            jnp.asarray(sv), outputs.shape[2] - 5)
        fg = np.asarray(j.fg_mask)
        assert fg.any()
        assert np.array_equal(res.fg_mask[b].numpy(), fg), b
        assert np.array_equal(res.matched_gt[b].numpy()[fg],
                              np.asarray(j.matched_gt)[fg]), b


def test_visualize_assignments_equals_jax(assign_case, tmp_path):
    m, v, pm, events, labels = assign_case
    ref = j_assign_viz.visualize_assignments(
        m, v, events, labels, save_prefix=str(tmp_path / "jax_"))
    mine = visualize_assignments(pm, events, labels,
                                 save_prefix=str(tmp_path / "port_"))
    assert len(mine) == 2 and mine[0].shape == (64, 64, 3)
    for i, (a, b) in enumerate(zip(ref, mine)):
        assert np.array_equal(a, b), i
        assert np.array_equal(cv2.imread(str(tmp_path / f"port_{i}.png")), a)
        assert np.array_equal(png.read_png(str(tmp_path / f"port_{i}.png")),
                              cv2.imread(str(tmp_path / f"jax_{i}.png")))


# -------------------------------------------------------------- tracker

def _frames_dets():
    """JAX's TestPredImageLogging case (tests/test_utils.py:225-234)."""
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 3, (2, 24, 32, 2)).astype(np.float32)
    det0 = np.array([
        [4.0, 5.0, 20.0, 18.0, 0.9, 0.8, 0.0],
        [1.0, 1.0, 8.0, 9.0, 0.7, 0.9, 1.0],
    ])
    return frames, [det0, None]


def test_tracker_writes_pngs_equal_to_jax_outside_labels(tmp_path):
    frames, dets = _frames_dets()
    t = MetricsTracker(str(tmp_path / "port"), backend="jsonl")
    written = t.log_pred_images(7, frames, dets, class_names=("car", "ped"))
    t.close()
    jt = j_tracking.MetricsTracker(str(tmp_path / "jax"), backend="jsonl")
    jwritten = jt.log_pred_images(7, frames, dets,
                                  class_names=("car", "ped"))
    jt.close()
    assert [os.path.relpath(p, str(tmp_path / "port")) for p in written] \
        == [os.path.relpath(p, str(tmp_path / "jax")) for p in jwritten] \
        == [os.path.join("pred_images", f"step00000007_{i}.png")
            for i in range(2)]
    for p, q, det in zip(written, jwritten, dets):
        mine, ref = cv2.imread(p), cv2.imread(q)
        assert mine.shape == (24, 32, 3)
        mask = np.zeros(mine.shape[:2], bool)
        if det is not None:
            mask = label_mask(mine.shape, det[:, :4], det[:, 4] * det[:, 5],
                              det[:, 6], 0.3, ("car", "ped"))
        assert np.array_equal(mine[~mask], ref[~mask])
        assert np.array_equal(png.read_png(p), mine)


def test_tracker_multislice_frames_collapse(tmp_path):
    t = MetricsTracker(str(tmp_path), backend="jsonl")
    frames = np.zeros((1, 1, 3, 16, 16, 2), np.float32)  # (B,Tl,Tm,...)
    frames[0, 0, 1, 2, 3, 1] = 1  # one positive event: white at (3, 2)
    frames[0, 0, 2, 5, 6, 0] = 2
    written = t.log_pred_images(1, frames, [None])
    uint8 = t.log_pred_images(2, [np.full((8, 8, 3), 9, np.uint8)], [None])
    t.close()
    assert len(written) == 1
    img = png.read_png(written[0])
    assert img.shape == (16, 16, 3)
    assert (img[2, 3] == 255).all() and (img[5, 6] == 0).all()
    assert (img.reshape(-1, 3) == 127).all(-1).sum() == 16 * 16 - 2
    assert (png.read_png(uint8[0]) == 9).all()  # a BGR image as it is


@pytest.fixture
def fake_wandb(monkeypatch):
    calls = {"logged": [], "artifacts": []}

    class _Run:
        def log(self, d, step=None):
            calls["logged"].append((step, d))

        def log_artifact(self, art):
            calls["artifacts"].append(art)

        def finish(self):
            pass

    class _Image:
        def __init__(self, img, boxes=None):
            self.img, self.boxes = img, boxes

    class _Artifact:
        def __init__(self, name, type):
            self.name, self.type, self.files, self.dirs = name, type, [], []

        def add_file(self, p):
            self.files.append(p)

        def add_dir(self, p):
            self.dirs.append(p)

    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: _Run()
    fake.Image = _Image
    fake.Artifact = _Artifact
    monkeypatch.setitem(sys.modules, "wandb", fake)
    return calls


def test_tracker_wandb_box_metadata_and_artifacts(tmp_path, fake_wandb):
    t = MetricsTracker(str(tmp_path), backend="wandb")
    frames, dets = _frames_dets()
    written = t.log_pred_images(3, frames, dets, class_names=("car", "ped"))
    ckpt = tmp_path / "best.pth"
    ckpt.write_bytes(b"x")
    t.log_artifact(str(ckpt), name="best_ckpt")
    t.log_artifact(str(tmp_path), name="run", kind="dir")
    t.close()
    media = [d for _, d in fake_wandb["logged"] if "val/predictions" in d]
    assert len(media) == 1
    imgs = media[0]["val/predictions"]
    assert len(imgs) == 2
    bd = imgs[0].boxes["predictions"]["box_data"]
    assert len(bd) == 2 and bd[0]["position"]["maxX"] == 20.0
    assert bd[1]["class_id"] == 1 and bd[0]["domain"] == "pixel"
    assert bd[0]["scores"]["conf"] == pytest.approx(0.72)
    assert imgs[0].boxes["predictions"]["class_labels"] == {
        0: "car", 1: "ped"}
    assert imgs[1].boxes["predictions"]["box_data"] == []
    # RGB to wandb: the PNG's BGR reversed
    assert np.array_equal(imgs[0].img, cv2.imread(written[0])[..., ::-1])
    arts = fake_wandb["artifacts"]
    assert [(a.name, a.type, a.files, a.dirs) for a in arts] == [
        ("best_ckpt", "model", [str(ckpt)], []),
        ("run", "dir", [], [str(tmp_path)])]
    # without wandb nothing is registered
    t = MetricsTracker(str(tmp_path / "plain"), backend="jsonl")
    t.log_artifact(str(ckpt), name="best_ckpt")
    t.close()
    assert len(fake_wandb["artifacts"]) == 2


# -------------------------------------------------------------- trainer

@pytest.fixture(scope="module")
def gen1(tmp_path_factory):
    from test_torch_data import write_tree
    return write_tree(str(tmp_path_factory.mktemp("gen1_pred")), groups=3)


@pytest.mark.parametrize("enabled", [True, False])
def test_trainer_writes_pred_images_after_evaluation(tmp_path, gen1,
                                                     monkeypatch, enabled):
    from test_torch_eval import _argv

    from eas_snn_tpu_torch.tools.train_event import build
    if not enabled:
        monkeypatch.setenv("EAS_LOG_PRED_IMAGES", "0")
    out = str(tmp_path / "out")
    exp, args = build(_argv(gen1, out) + ["max_epoch", "1"])
    exp.iters_per_epoch = 1
    tr = exp.get_trainer(args, device="cpu")
    tr.train()
    run = os.path.join(out, "gen1_syolox_s")
    img_dir = os.path.join(run, "pred_images")
    if not enabled:
        assert not os.path.exists(img_dir)
        return
    names = sorted(os.listdir(img_dir))
    assert names == [f"step00000001_{i}.png" for i in range(2)]
    for n in names:
        img = png.read_png(os.path.join(img_dir, n))
        assert img.shape == (32, 32, 3)
    assert "pred-image logging skipped" not in open(
        os.path.join(run, "train_log.txt")).read()
