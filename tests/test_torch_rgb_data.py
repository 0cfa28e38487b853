"""The RGB data layer, port against the JAX package on the CPU: COCO and
VOC trees of JPEGs that cv2 writes here (several samplings and sizes, a
restart interval, a grey image, one PNG under a ``.jpg`` name), read by
``COCODataset``, ``VOCDataset`` and ``MosaicDataset`` of both packages
sample for sample in train, val and map_val modes.

Tolerances (the data layer's, ``tests/test_torch_data.py``): labels,
image sizes and ids bit-equal; the frames of the uint8 paths (mosaic,
affine, mixup, the no-mosaic letterbox, close_mosaic) bit-equal; the
float letterbox and random resize of ``_emit`` through
``data/augment.py:resize_frames`` within RESIZE_TOL (2e-4) of |x| + 1 of
cv2's, the rule ``tests/test_torch_data.py`` states for that resize.
Also: a loader batch with the per-worker reseed, and a subprocess with
jax, flax, optax, orbax, the JAX package, cv2 and PIL blocked reading a
JPEG COCO tree through ``MosaicDataset``.
"""

import itertools
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from eas_snn_tpu.data.coco import COCODataset as JCOCODataset
from eas_snn_tpu.data.coco import VOCDataset as JVOCDataset
from eas_snn_tpu.data.mosaic import MosaicDataset as JMosaicDataset

from eas_snn_tpu_torch.data import loader as ploader
from eas_snn_tpu_torch.data.coco import VOC_CLASSES, COCODataset, VOCDataset
from eas_snn_tpu_torch.data.mosaic import MosaicDataset
from eas_snn_tpu_torch.utils.png import write_png

from test_torch_data import RESIZE_TOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (96, 128)  # (h, w) of the model input

# (h, w, cv2.imwrite params) of each image: samplings, odd sizes, a
# restart interval, an optimized table
_IMAGES = [
    (120, 160, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]),
    (97, 131, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    (150, 110, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
    (64, 200, [cv2.IMWRITE_JPEG_QUALITY, 60, cv2.IMWRITE_JPEG_OPTIMIZE, 1]),
    (100, 100, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]),
    (88, 140, None),  # PNG bytes under the .jpg name
    (72, 90, "grey"),  # a one-component JPEG
]


def _img(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 80 * np.sin(x / (6.0 + c) + c) * np.cos(y / 7.0)
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _boxes(rng, h, w, n):
    """n xywh boxes inside an h x w image."""
    out = []
    for _ in range(n):
        bw, bh = rng.uniform(0.15, 0.6) * w, rng.uniform(0.15, 0.6) * h
        out.append([float(rng.uniform(0, w - bw)),
                    float(rng.uniform(0, h - bh)), float(bw), float(bh)])
    return out


def _write_image(path, img, params):
    if params is None:
        write_png(path, img)
    elif params == "grey":
        assert cv2.imwrite(path, img[..., 1])
    else:
        assert cv2.imwrite(path, img, params)


def build_coco_tree(root, split="train2017", seed=0):
    """A COCO tree of the _IMAGES (1-3 boxes each, two categories, one
    crowd box that is dropped), split ``split``."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, split), exist_ok=True)
    images, anns = [], []
    for i, (h, w, params) in enumerate(_IMAGES):
        name = f"{i:012d}.jpg"
        _write_image(os.path.join(root, split, name), _img(rng, h, w), params)
        images.append({"id": 10 + i, "file_name": name, "width": w,
                       "height": h})
        for j, b in enumerate(_boxes(rng, h, w, 1 + i % 3)):
            anns.append({"id": len(anns), "image_id": 10 + i,
                         "category_id": (3, 7)[j % 2], "bbox": b,
                         "iscrowd": int(i == 2 and j == 1)})
    with open(os.path.join(root, "annotations",
                           f"instances_{split}.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 7, "name": "truck"},
                                  {"id": 3, "name": "car"}]}, f)
    return root


def build_voc_tree(root, seed=1):
    """VOC2007 (trainval and test) of the _IMAGES; some objects difficult,
    one of a class VOC does not have."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "VOC2007")
    for d in ("ImageSets/Main", "Annotations", "JPEGImages"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    ids = []
    for i, (h, w, params) in enumerate(_IMAGES):
        img_id = f"{i:06d}"
        ids.append(img_id)
        _write_image(os.path.join(base, "JPEGImages", f"{img_id}.jpg"),
                     _img(rng, h, w), params)
        objs = []
        for j, (x, y, bw, bh) in enumerate(_boxes(rng, h, w, 2 + i % 2)):
            name = ("car", "person", "dog", "unicorn")[(i + j) % 4]
            objs.append(
                f"<object><name>{name}</name>"
                f"<difficult>{int(j == 1)}</difficult><bndbox>"
                f"<xmin>{int(x) + 1}</xmin><ymin>{int(y) + 1}</ymin>"
                f"<xmax>{int(x + bw)}</xmax><ymax>{int(y + bh)}</ymax>"
                "</bndbox></object>")
        with open(os.path.join(base, "Annotations", f"{img_id}.xml"),
                  "w") as f:
            f.write(f"<annotation>{''.join(objs)}</annotation>")
    for split in ("trainval", "test"):
        with open(os.path.join(base, "ImageSets", "Main", f"{split}.txt"),
                  "w") as f:
            f.write("\n".join(ids) + "\n")
    return root


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return build_coco_tree(str(tmp_path_factory.mktemp("coco")))


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return build_voc_tree(str(tmp_path_factory.mktemp("voc")))


def _same(got, want, frames_exact):
    gf, gl, gs, gi = got
    wf, wl, ws, wi = want
    assert gf.shape == wf.shape and gf.dtype == wf.dtype == np.float32
    if frames_exact:
        assert np.array_equal(gf, wf)
    else:
        np.testing.assert_array_less(np.abs(gf - wf),
                                     RESIZE_TOL * (1.0 + np.abs(wf)) + 1e-12)
    assert gl.dtype == wl.dtype and np.array_equal(gl, wl)
    assert tuple(gs) == tuple(ws) and gi == wi


@pytest.mark.parametrize("mode", ["train", "val", "map_val"])
def test_coco_dataset_matches_jax(coco, mode):
    kw = dict(input_size=SIZE, training=mode == "train",
              map_val=mode == "map_val", max_labels=10)
    p, j = COCODataset(coco, **kw), JCOCODataset(coco, **kw)
    assert p.class_names == j.class_names == ("car", "truck")
    assert p.sample_names == j.sample_names
    for a, b in zip(p.annotations, j.annotations):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for i in list(range(len(p))) * (2 if mode == "train" else 1):
        _same(p[i], j[i], frames_exact=False)


@pytest.mark.parametrize("mode", ["train", "val", "map_val"])
def test_voc_dataset_matches_jax(voc, mode):
    sets = (("2007", "trainval" if mode == "train" else "test"),)
    kw = dict(image_sets=sets, input_size=SIZE, training=mode == "train",
              map_val=mode == "map_val", max_labels=10)
    p, j = VOCDataset(voc, **kw), JVOCDataset(voc, **kw)
    assert p.class_names == VOC_CLASSES and len(p) == len(j) == 7
    for i in range(len(p)):
        root, img_id = p.ids[i]
        assert np.array_equal(p.annotations[i],
                              j._load_annotation(root, img_id))
        _same(p[i], j[i], frames_exact=False)


@pytest.mark.parametrize("mosaic_prob,mixup_prob,seed", [
    (1.0, 1.0, 0), (1.0, 1.0, 1), (1.0, 0.0, 2), (0.5, 0.5, 3)])
def test_mosaic_matches_jax(coco, mosaic_prob, mixup_prob, seed):
    """Mosaic, affine, mixup and the no-mosaic letterbox: uint8 paths,
    frames and labels bit-equal, draws in the JAX order."""
    kw = dict(input_size=SIZE, mosaic_prob=mosaic_prob,
              mixup_prob=mixup_prob, max_labels=30, seed=seed)
    p = MosaicDataset(COCODataset(coco, input_size=SIZE), **kw)
    j = JMosaicDataset(JCOCODataset(coco, input_size=SIZE), **kw)
    n_boxes = 0
    for i in [0, 3, 5, 1, 6, 2, 4, 0, 6]:
        got, want = p[i], j[i]
        _same(got, want, frames_exact=True)
        n_boxes += int((got[1].sum(-1) != 0).sum())
    assert n_boxes > 0
    # the generators drew the same numbers
    assert p.rng.uniform() == j.rng.uniform()


def test_close_mosaic_matches_jax(coco):
    p = MosaicDataset(COCODataset(coco, input_size=SIZE), input_size=SIZE)
    j = JMosaicDataset(JCOCODataset(coco, input_size=SIZE), input_size=SIZE)
    p.close_mosaic()
    j.close_mosaic()
    assert not p.enable_mosaic
    for i in range(len(_IMAGES)):
        _same(p[i], j[i], frames_exact=True)


def test_mosaic_over_voc(voc):
    """MosaicDataset over VOCDataset (the yolox_voc_s train view): the
    port's VOCDataset has the ``_read`` and ``annotations`` the mosaic
    reads (the JAX VOCDataset has neither, so its VOC training stops at
    the first mosaic; ROADMAP.md §3)."""
    base = VOCDataset(voc, input_size=SIZE, training=True)
    ds = MosaicDataset(base, input_size=SIZE, max_labels=20, seed=4)
    frames, labels, size, sid = ds[2]
    assert frames.shape == (1, 1) + SIZE + (3,) and size == SIZE
    assert (labels.sum(-1) != 0).sum() > 0 and sid == 2


def test_loader_batch_with_worker_reseed(coco):
    """Two workers over the mosaic: batch k comes from worker k % 2, whose
    ``MosaicDataset.rng`` is reseeded ``seed + 1000 * (wid + 1)``; each
    batch equals a dataset copy seeded that way."""
    seed = 5

    def make():
        return MosaicDataset(COCODataset(coco, input_size=SIZE),
                             input_size=SIZE, max_labels=30)

    ld = ploader.EventDataLoader(make(), batch_size=2, num_workers=2,
                                 seed=seed)
    it = iter(ld)
    got = [next(it) for _ in range(2)]
    order = list(itertools.islice(iter(ploader.InfiniteSampler(
        len(_IMAGES), seed=seed)), 4))
    for wid in range(2):
        ref = make()
        ref.rng = np.random.default_rng(ploader.worker_seed(seed, wid))
        for k in range(2):
            frames, lab, _, sid = ref[order[2 * wid + k]]
            assert torch.equal(got[wid][0][k], torch.from_numpy(frames))
            assert np.array_equal(got[wid][1][k].numpy(), lab)
            assert int(got[wid][3][k]) == sid
    assert got[0][0].shape == (2, 1, 1) + SIZE + (3,)
    del it, ld


_BLOCKED = """
import sys
for name in ("jax", "flax", "optax", "orbax", "eas_snn_tpu", "cv2", "PIL"):
    sys.modules[name] = None
import numpy as np
from eas_snn_tpu_torch.data import COCODataset, MosaicDataset, imread
from eas_snn_tpu_torch.exp import get_exp
root = sys.argv[1]
ds = MosaicDataset(COCODataset(root, input_size=(96, 128)),
                   input_size=(96, 128), seed=1)
for i in range(len(ds)):
    frames, labels, size, sid = ds[i]
    assert frames.shape == (1, 1, 96, 128, 3) and np.isfinite(frames).all()
assert imread(root + "/train2017/000000000000.jpg").shape == (120, 160, 3)
exp = get_exp("yolox_s")
exp.data_dir, exp.input_size, exp.data_num_workers = root, (96, 128), 0
assert exp.get_dataset(training=True)[0][0].shape == (1, 1, 96, 128, 3)
assert not any(k.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                   "eas_snn_tpu", "cv2", "PIL")
               for k in sys.modules if sys.modules[k] is not None)
print("ok")
"""


def test_mosaic_reads_jpegs_with_jax_cv2_and_pil_blocked(coco):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", _BLOCKED, coco], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
