"""The port's other datasets (``eas_snn_tpu_torch/data``: N-Caltech101,
raw and RVT 1Mpx, their unions, the representations and the frame cache
they use, ``build_dataset``) and its Prophesee folder evaluation, against
the JAX package's on the same files and seeds.

Tolerances: integer arithmetic, counts, file bytes, label boxes and random
draws are bit-equal, and so are the representations (the same float64
numpy in the same order); a frame that goes through the bilinear resize
(the port's ``F.interpolate`` against ``cv2.resize``) agrees within
RESIZE_TOL of |x| + 1 (``tests/test_torch_data.py``); AP is compared
with ``==``.
"""

import filecmp
import os
import shutil

import numpy as np
import pytest

from eas_snn_tpu.data import build_dataset as jbuild_dataset
from eas_snn_tpu.data import cache as jcache
from eas_snn_tpu.data import concat as jconcat
from eas_snn_tpu.data import gen4 as jgen4
from eas_snn_tpu.data import ncaltech as jnc
from eas_snn_tpu.data import psee_io as jio
from eas_snn_tpu.data import reps as jreps
from eas_snn_tpu.data.gen1 import Gen1Dataset as JGen1Dataset
from eas_snn_tpu.evaluators import evaluate_lists as jevaluate_lists

from eas_snn_tpu_torch.data import build_dataset
from eas_snn_tpu_torch.data import cache as pcache
from eas_snn_tpu_torch.data import concat as pconcat
from eas_snn_tpu_torch.data import gen4 as pgen4
from eas_snn_tpu_torch.data import ncaltech as pnc
from eas_snn_tpu_torch.data import psee_io as pio
from eas_snn_tpu_torch.data import reps as preps
from eas_snn_tpu_torch.data.gen1 import Gen1Dataset as PGen1Dataset
from eas_snn_tpu_torch.data.loader import EventDataLoader
from eas_snn_tpu_torch.evaluators import PSEEEvaluator
from eas_snn_tpu_torch.tools import psee_evaluate_folders

from test_torch_data import RESIZE_TOL, write_tree

NC_CLASSES = ("ant", "bee", "cup")


def _close_frames(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_less(np.abs(got - want),
                                 RESIZE_TOL * (1.0 + np.abs(want)) + 1e-12)


def _same_sample(p, j):
    (pf, pl, ps, pid), (jf, jl, js, jid) = p, j
    _close_frames(pf, jf)
    np.testing.assert_array_equal(pl, jl)
    assert tuple(ps) == tuple(js) and pid == jid


def _atis_events(rng, n, duration=300_000):
    return (np.sort(rng.integers(0, duration, n)), rng.integers(0, 240, n),
            rng.integers(0, 180, n), rng.integers(0, 2, n))


def write_ncaltech_tree(root, per_class=5, n_events=3000, seed=0):
    """N-Caltech101's layout, written with the port's writers: a folder a
    class under ``Caltech101/`` and ``Caltech101_annotations/``, plus
    ``BACKGROUND_Google``, ``per_class`` recordings each."""
    rng = np.random.default_rng(seed)
    for cls in NC_CLASSES + ("BACKGROUND_Google",):
        ddir = os.path.join(root, "Caltech101", cls)
        adir = os.path.join(root, "Caltech101_annotations", cls)
        os.makedirs(ddir)
        os.makedirs(adir)
        for i in range(per_class):
            with open(os.path.join(ddir, f"image_{i:04d}.bin"), "wb") as f:
                f.write(pnc.encode_atis(*_atis_events(rng, n_events)))
            x1, y1 = rng.integers(0, 120), rng.integers(0, 90)
            pnc.write_ncaltech_annotation(
                os.path.join(adir, f"annotation_{i:04d}.bin"),
                [x1, y1, x1 + rng.integers(20, 110),
                 y1 + rng.integers(20, 80)])
    return root


@pytest.fixture(scope="module")
def nc_trees(tmp_path_factory):
    """Two copies of one N-Caltech tree, one for each package (each writes
    its own split files)."""
    base = tmp_path_factory.mktemp("ncaltech")
    j = write_ncaltech_tree(str(base / "jax"))
    p = str(base / "port")
    shutil.copytree(j, p)
    return j, p


@pytest.fixture(scope="module")
def gen1_tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("gen1")), groups=4)


def write_gen4_tree(root, streams=2, groups=3, seed=0):
    """Raw 1Mpx streams at 720x1280 with labels over all 7 classes, some
    outside the frame, too small or too wide for RVT's filters."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for s in range(streams):
        n = 20_000
        t = np.sort(rng.integers(0, 400_000 + groups * 100_000, n))
        pio.write_dat_events(os.path.join(root, f"moorea_{s}_td.dat"), t,
                             rng.integers(0, 1280, n),
                             rng.integers(0, 720, n), rng.integers(0, 2, n),
                             height=720, width=1280)
        rows = []
        for k in range(groups):
            for j in range(5):
                w, h = rng.uniform(2, 1250), rng.uniform(2, 300)
                rows.append((300_000 + 100_000 * k, rng.uniform(-50, 1200),
                             rng.uniform(-50, 700), w, h,
                             int(rng.integers(0, 7)), j, 1.0))
        pio.write_bboxes_npy(os.path.join(root, f"moorea_{s}_bbox.npy"),
                             rows)
    return root


@pytest.fixture(scope="module")
def gen4_tree(tmp_path_factory):
    return write_gen4_tree(str(tmp_path_factory.mktemp("gen4")))


# ---------------------------------------------------------------- reps

def _decoded(rng, n):
    ev = np.zeros(n, pio.EVENT_DTYPE)
    t = np.sort(rng.integers(0, 400_000, n))
    ev["t"], ev["x"], ev["y"], ev["p"] = (t, rng.integers(0, 304, n),
                                          rng.integers(0, 240, n),
                                          rng.integers(0, 2, n))
    return ev


@pytest.mark.parametrize("rep", ["voxel_grid", "voxel_cube", "timesurface",
                                 "timesurface_measure"])
def test_representations_equal_jax_bitwise(rep):
    rng = np.random.default_rng(1)
    for n in (0, 1, 3, 7000):
        ev = _decoded(rng, n)
        if rep == "voxel_grid":
            args = [(ev, 240, 304, 4), (ev, 240, 304, 10)]
        elif rep == "voxel_cube":
            args = [(ev, 240, 304, 3), (ev, 240, 304, 4, 3)]
        elif rep == "timesurface":
            slices, dt = preps.slice_time_windows(ev, 4)
            args = [(slices, 240, 304, dt, 50e3), (slices, 240, 304, dt,
                                                   10e3)]
        else:
            t = ev["t"].astype(np.float64)
            args = [(t, 400_000.0, 5e5, d) for d in ("exp", "tanh", "lin")]
        for a in args:
            got = getattr(preps, rep)(*a)
            want = getattr(jreps, rep)(*a)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="decay"):
        preps.timesurface_measure(np.zeros(2), 0.0, 1.0, "cubic")


# --------------------------------------------------------------- cache

@pytest.mark.parametrize("where", ["ram", "disk"])
def test_sample_cache_equals_jax(tmp_path, where):
    caches = [mod.SampleCache(str(tmp_path / tag) if where == "disk"
                              else None, max_items=2)
              for mod, tag in ((jcache, "j"), (pcache, "p"))]
    rng = np.random.default_rng(2)
    arrays = {f"seq/{i}_r0_a{i}": rng.normal(size=(2, 3, 4)).astype(
        np.float32) for i in range(3)}
    for c in caches:
        assert c.read("seq/0_r0_a0") is None
        for k, v in arrays.items():
            c.write(k, v)
        assert len(c) == 2  # the oldest left RAM
        for k, v in arrays.items():
            hit = c.read(k)
            if where == "ram" and k == "seq/0_r0_a0":
                assert hit is None
            else:
                np.testing.assert_array_equal(hit, v)
    if where == "disk":
        names = [sorted(os.listdir(tmp_path / tag)) for tag in ("j", "p")]
        assert names[0] == names[1] and len(names[0]) == 3
        fresh = pcache.SampleCache(str(tmp_path / "j"))
        for k, v in arrays.items():
            np.testing.assert_array_equal(fresh.read(k), v)


# ------------------------------------------------ EventDetDataset: Gen1

@pytest.mark.parametrize("aggregation", ["sum", "micro_sum", "voxel_grid",
                                         "voxel_cube", "timesurface"])
@pytest.mark.parametrize("cache", [None, "ram", "disk"])
def test_every_aggregation_and_the_cache_equal_jax(gen1_tree, tmp_path,
                                                   aggregation, cache):
    kw = dict(aggregation=aggregation, num_slice=2, micro_slice=3,
              window=(-100_000, 0), max_labels=20, training=True,
              flip_prob=0.5)
    jd = JGen1Dataset(gen1_tree, input_size=(64, 96), **kw, cache_path=(
        str(tmp_path / "j") if cache == "disk" else cache))
    pd = PGen1Dataset(gen1_tree, input_size=(64, 96), **kw, cache_path=(
        str(tmp_path / "p") if cache == "disk" else cache))
    for i in (0, 5, 0):  # the second read of 0 comes from the cache
        _same_sample(pd[i], jd[i])
    # the empty window's shapes
    np.testing.assert_array_equal(pd.aggregate(None), jd.aggregate(None))
    if cache == "disk":
        assert sorted(os.listdir(tmp_path / "p")) == sorted(
            os.listdir(tmp_path / "j"))


# ------------------------------------------------------------ N-Caltech

def test_atis_encode_decode_equal_jax():
    rng = np.random.default_rng(3)
    t, x, y, p = _atis_events(rng, 2000, duration=(1 << 23) - 1)
    y[[5, 700, 701, 1500]] = 240  # overflow rows: +2^13 us after each
    data = pnc.encode_atis(t, x, y, p)
    assert data == jnc.encode_atis(t, x, y, p)
    for window in (None, (-100_000, 0), (-3_000_000, -1_000_000), (0, 0)):
        got = pnc.read_atis_events(data, window)
        want = jnc.read_atis_events(data, window)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    full = pnc.read_atis_events(data)
    assert len(full) == 1996
    assert full["t"][-1] == t[-1] + 4 * 8192
    with pytest.raises(ValueError, match="2\\^23"):
        pnc.encode_atis([1 << 23], [0], [0], [0])


def test_annotations_and_split_files_equal_jax(nc_trees):
    jroot, proot = nc_trees
    for cls in NC_CLASSES:
        adir = os.path.join(proot, "Caltech101_annotations", cls)
        for name in sorted(os.listdir(adir)):
            got = pnc.read_ncaltech_annotation(os.path.join(adir, name))
            want = jnc.read_ncaltech_annotation(os.path.join(adir, name))
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
    jnc.write_split_files(jroot)
    pnc.write_split_files(proot)
    for split in ("train", "val", "test"):
        assert filecmp.cmp(os.path.join(jroot, f"{split}.txt"),
                           os.path.join(proot, f"{split}.txt"),
                           shallow=False)
    # an existing train.txt is kept
    with open(os.path.join(proot, "train.txt"), "a") as f:
        f.write("# kept\n")
    pnc.write_split_files(proot, seed=5)
    assert open(os.path.join(proot, "train.txt")).read().endswith("# kept\n")
    lines = open(os.path.join(proot, "train.txt")).read().splitlines()[:-1]
    open(os.path.join(proot, "train.txt"), "w").writelines(
        ln + "\n" for ln in lines)


@pytest.mark.parametrize("mode,aggregation,measure,speed_aug", [
    ("train", "micro_sum", "count", False),
    ("train", "sum", "timesurface", True),
    ("map_val", "micro_sum", "count", False),
    ("val", "voxel_cube", "count", False),
    ("val", "voxel_grid", "count", False),
    ("map_val", "timesurface", "count", False),
])
def test_ncaltech_samples_equal_jax(nc_trees, mode, aggregation, measure,
                                    speed_aug):
    jroot, proot = nc_trees
    train = mode == "train"
    kw = dict(input_size=(64, 64), split="train" if train else "val",
              training=train, map_val=mode == "map_val",
              aggregation=aggregation, measure=measure, num_slice=1,
              micro_slice=4, max_labels=10, speed_aug=speed_aug,
              flip_prob=0.5 if train else 0.0)
    jd = jnc.NCaltechDataset(jroot, **kw)
    pd = pnc.NCaltechDataset(proot, **kw)
    assert len(pd) == len(jd) == (12 if train else 3)
    assert pd.class_names == jd.class_names == NC_CLASSES
    assert pd.sample_names == jd.sample_names
    assert pd.jitter == jd.jitter == 0.1
    for i in range(3):
        _same_sample(pd[i], jd[i])


def test_build_ncaltech_applies_the_window_rule(nc_trees):
    jroot, proot = nc_trees
    for window in ((0, 0), (-100_000, 0), (50_000, 0)):
        kw = dict(training=False, map_val=True, input_size=(64, 64),
                  aggregation="micro_sum", num_slice=1, micro_slice=2,
                  window=window)
        pd = build_dataset("n-caltech", proot, **kw)
        jd = jbuild_dataset("n-caltech", jroot, **kw)
        assert pd.stream_window == jd.stream_window
        assert pd.window == jd.window
        _same_sample(pd[1], jd[1])


# ----------------------------------------------------------------- 1Mpx

def test_label_filters_equal_jax():
    rng = np.random.default_rng(4)
    n = 400
    cols = [rng.uniform(-100, 1300, n), rng.uniform(-100, 800, n),
            rng.uniform(0, 1300, n), rng.uniform(0, 400, n)]
    cls = rng.integers(0, 7, n).astype(np.float32)
    pcols = [c.astype(np.float32) for c in cols]
    jcols = [c.copy() for c in pcols]
    got = pgen4.apply_label_filters(*pcols, cls, 720, 1280)
    want = jgen4.apply_label_filters(*jcols, cls, 720, 1280)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < n
    for a, b in zip(pcols, jcols):
        np.testing.assert_array_equal(a, b)
    assert pgen4.GEN4_CLASSES == jgen4.GEN4_CLASSES


@pytest.mark.parametrize("mode", ["train", "map_val"])
def test_gen4_samples_equal_jax(gen4_tree, mode):
    train = mode == "train"
    kw = dict(input_size=(96, 160), training=train, map_val=not train,
              aggregation="micro_sum", num_slice=1, micro_slice=3,
              window=(-200_000, 0), max_labels=10,
              flip_prob=0.5 if train else 0.0)
    jd = jgen4.Gen4Dataset(gen4_tree, **kw)
    pd = pgen4.Gen4Dataset(gen4_tree, **kw)
    assert pd.img_size == (720, 1280) and pd.class_names == \
        pgen4.GEN4_CLASSES
    assert len(pd) == len(jd) and pd.sample_names == jd.sample_names
    for (pt, pb), (jt, jb) in zip(
            (g for f in pd.labels for g in f),
            (g for f in jd.labels for g in f)):
        assert pt == jt
        np.testing.assert_array_equal(pb, jb)
    kept = np.concatenate([b for f in pd.labels for _, b in f])
    assert len(kept) and (kept[:, 4] <= 2).all()
    for i in range(min(3, len(pd))):
        _same_sample(pd[i], jd[i])


def test_rvt_gen4_samples_equal_jax(tmp_path):
    pytest.importorskip("h5py")
    from test_gen4 import build_rvt_tree

    root = build_rvt_tree(tmp_path, np.random.default_rng(5), n_frames=3)
    for num_slice, filt in ((3, False), (6, True)):
        kw = dict(input_size=(96, 160), training=False, map_val=True,
                  num_slice=num_slice, micro_slice=num_slice,
                  max_labels=10, filter_labels=filt)
        jd = jgen4.RVTGen4Dataset(root, **kw)
        pd = pgen4.RVTGen4Dataset(root, **kw)
        assert len(pd) == len(jd) == 6 and pd.img_size == (360, 640)
        assert pd.sample_names == jd.sample_names
        for i in range(len(pd)):
            fi, gi = pd.resolve_index(i)
            raw = pd.generate_slices(fi, gi)
            np.testing.assert_array_equal(raw, jd.generate_slices(fi, gi))
            assert raw.shape == (1, num_slice, 360, 640, 2)
            _same_sample(pd[i], jd[i])


# --------------------------------------------------------------- concat

class _Listed:
    """A child dataset of (frames, labels, size, sid) tuples that also
    takes a (flag, index) tuple, as a mosaic child does."""

    def __init__(self, n, tag):
        self.n, self.tag = n, tag
        self.sample_names = [f"{tag}{i}" for i in range(n)]
        self.input_size, self.class_names = (8, 8), ("a",)
        self.training, self.closed = True, False

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        flag, i = index[:2] if isinstance(index, tuple) else (None, index)
        return (np.full(2, i, np.float32), self.tag, flag, i)

    def close_mosaic(self):
        self.closed = True


def test_concat_index_splicing_equals_jax():
    for pmod_cls, jmod_cls in ((pconcat.ConcatDataset,
                                jconcat.ConcatDataset),
                               (pconcat.MixConcatDataset,
                                jconcat.MixConcatDataset)):
        pc = pmod_cls([_Listed(3, "a"), _Listed(4, "b"), _Listed(2, "c")])
        jc = jmod_cls([_Listed(3, "a"), _Listed(4, "b"), _Listed(2, "c")])
        assert len(pc) == len(jc) == 9
        assert pc.sample_names == jc.sample_names
        for i in list(range(9)) + [-1, -9]:
            got, want = pc[i], jc[i]
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
        with pytest.raises(ValueError):
            pc[-10]
        pc.training = False
        assert all(not d.training for d in pc.datasets)
        pc.close_mosaic()
        assert all(d.closed for d in pc.datasets)
    mix_p = pconcat.MixConcatDataset([_Listed(3, "a"), _Listed(4, "b")])
    mix_j = jconcat.MixConcatDataset([_Listed(3, "a"), _Listed(4, "b")])
    for index in ((True, 5), (False, 1), (True, 3, 0.5)):
        got, want = mix_p[index], mix_j[index]
        assert got[1:] == want[1:]
    with pytest.raises(ValueError, match="at least one"):
        pconcat.ConcatDataset([])


def test_concat_of_gen1_splits_reindexes_sample_ids(gen1_tree):
    kw = dict(input_size=(64, 96), training=False, map_val=True,
              aggregation="sum", num_slice=1, micro_slice=1,
              window=(-50_000, 0))
    parts = [PGen1Dataset(gen1_tree, **kw) for _ in range(2)]
    cat = pconcat.ConcatDataset(parts)
    assert len(cat) == 2 * len(parts[0])
    n = len(parts[0])
    for i in (0, n - 1, n, 2 * n - 1):
        assert cat[i][3] == i
        assert cat.sample_names[i] == parts[i // n].sample_names[i % n]


# --------------------------------------------------------- build_dataset

def test_build_dataset_takes_every_jax_name(nc_trees, gen1_tree, gen4_tree,
                                            tmp_path):
    pytest.importorskip("h5py")
    from test_gen4 import build_rvt_tree

    rvt = build_rvt_tree(tmp_path, np.random.default_rng(6), n_seq=1,
                         n_frames=2)
    jroot, proot = nc_trees
    kw = dict(input_size=(64, 64), aggregation="micro_sum", num_slice=1,
              micro_slice=2, window=(-50_000, 0), max_labels=10)
    cases = [(n, proot, jroot) for n in ("n-caltech", "ncaltech",
                                         "N-Caltech101")]
    cases += [("gen1", gen1_tree, gen1_tree), ("Gen4", gen4_tree, gen4_tree)]
    cases += [(n, rvt, rvt) for n in ("rvt-gen4", "rvt_gen4", "rvtgen4")]
    for name, pdir, jdir in cases:
        for training in (True, False):
            pd = build_dataset(name, pdir, training=training, **kw)
            jd = jbuild_dataset(name, jdir, training=training, **kw)
            assert type(pd).__name__ == type(jd).__name__, name
            assert len(pd) == len(jd) > 0, name
            assert pd.sample_names == jd.sample_names, name
            assert pd.training == training
    for fn in (build_dataset, jbuild_dataset):
        with pytest.raises(KeyError, match="unknown dataset"):
            fn("coco", gen1_tree)
    # gen1's split rule: <data_dir>/train where it exists
    split = tmp_path / "split"
    shutil.copytree(gen1_tree, split / "train")
    pd = build_dataset("gen1", str(split), training=True, **kw)
    jd = jbuild_dataset("gen1", str(split), training=True, **kw)
    assert pd.data_dir == jd.data_dir == str(split / "train")
    assert build_dataset("n-caltech", proot, training=True, speed_aug=True,
                         **kw).speed_aug


# ----------------------------------------------------- Prophesee folders

def _random_boxes(rng, n, times):
    rows = [(int(rng.choice(times)), rng.uniform(0, 250), rng.uniform(0, 200),
             rng.uniform(15, 90), rng.uniform(15, 70), int(rng.integers(0, 2)),
             0, float(rng.uniform(0.05, 1))) for _ in range(n)]
    arr = np.zeros(len(rows), pio.BBOX_DTYPE)
    for i, r in enumerate(rows):
        arr[i] = r
    return arr[np.argsort(arr["t"], kind="stable")]


def test_psee_evaluate_folders_equals_jax_evaluate_lists(tmp_path):
    rng = np.random.default_rng(7)
    times = np.arange(600_000, 2_000_000, 200_000)
    gt_l, dt_l = [], []
    for s in range(3):
        gt = _random_boxes(rng, 30, times)
        gt["class_confidence"] = 1.0
        dt = np.concatenate([gt, _random_boxes(rng, 40, times)])
        dt["x"] += rng.normal(0, 3, len(dt)).astype(np.float32)
        dt["class_confidence"] = rng.uniform(0.05, 1, len(dt))
        dt = dt[np.argsort(dt["t"], kind="stable")]
        np.save(tmp_path / f"seq{s}_bbox.npy", gt)
        (tmp_path / "dt").mkdir(exist_ok=True)
        np.save(tmp_path / "dt" / f"seq{s}.npy", dt)
        gt_l.append(gt)
        dt_l.append(dt)
    for camera, ds2 in (("gen1", False), ("gen4", True)):
        got = psee_evaluate_folders.main(
            ["--gt", str(tmp_path), "--dt", str(tmp_path / "dt"),
             "--camera", camera] + (["--downsampled-by-2"] if ds2 else []))
        want = jevaluate_lists(dt_l, gt_l, camera=camera,
                               downsampled_by_2=ds2)
        assert 0 < got["AP"] < 1
        for k, v in want.items():
            if not isinstance(v, dict):
                assert got[k] == v, k
    assert psee_evaluate_folders.find_prediction(
        str(tmp_path / "dt"), "seq1").endswith("seq1.npy")
    with pytest.raises(FileNotFoundError):
        psee_evaluate_folders.find_prediction(str(tmp_path / "dt"), "seq9")


def test_saved_box_files_give_the_evaluators_ap(tmp_path):
    """``PSEEEvaluator(box_dir=...)`` saves what it evaluates; the folder
    tool over those files gives its AP, on a Gen1 map_val split with
    noisy predictions."""
    root = write_tree(str(tmp_path / "gen1"), streams=2, groups=8,
                      n_events=3000, seed=3)
    # labels 250 ms apart: one per Prophesee window of +-50 ms
    for s in range(2):
        path = os.path.join(root, f"seq{s}_bbox.npy")
        b = jio.load_bboxes(path)
        b["t"] = 600_000 + (b["t"] - b["t"].min()) * 5
        np.save(path, b)
    ds = PGen1Dataset(root, input_size=(64, 96), training=False,
                      map_val=True, aggregation="sum", num_slice=1,
                      micro_slice=1, window=(-50_000, 0), max_labels=10)
    loader = EventDataLoader(ds, batch_size=4, shuffle=False, infinite=False,
                             num_workers=0)
    rng = np.random.default_rng(8)
    order = iter(range(len(ds)))
    scale = min(64 / 240, 96 / 304)

    def forward(frames):
        out = np.zeros((frames.shape[0], 12, 7), np.float32)
        for b in range(frames.shape[0]):
            boxes = ds.raw_boxes(*ds.resolve_index(next(order)))
            for j, (x1, y1, x2, y2, c) in enumerate(boxes):
                out[b, j, :4] = (np.array([(x1 + x2) / 2, (y1 + y2) / 2,
                                           x2 - x1, y2 - y1]) * scale
                                 + rng.normal(0, 1.5, 4))
                out[b, j, 4] = rng.uniform(0.3, 1.0)
                out[b, j, 5 + int(c)] = 1.0
        return out

    ev = PSEEEvaluator(loader, (64, 96), confthre=0.001, nmsthre=0.65,
                       num_classes=2, box_dir=str(tmp_path / "boxes"))
    ap, ap50, _ = ev.evaluate(forward)
    got = psee_evaluate_folders.main(["--gt", str(tmp_path / "boxes" / "gt"),
                                      "--dt", str(tmp_path / "boxes" / "dt")])
    assert 0 < ap < 1 and got["AP"] == ap and got["AP_50"] == ap50
    assert sorted(os.listdir(tmp_path / "boxes" / "dt")) == ["seq0.npy",
                                                             "seq1.npy"]


# --------------------------------------------------------- entry points

@pytest.mark.parametrize("data_name,camera,ds2", [
    ("gen1", "gen1", False), ("gen4", "gen4", False),
    ("rvt-gen4", "gen4", True), ("n-caltech", None, None)])
def test_evaluator_choice_equals_jax(monkeypatch, data_name, camera, ds2):
    """``get_evaluator`` under ``eval_proph``: the Prophesee protocol with
    the camera and the ds2 halving of the JAX exp's choice on gen* data,
    the COCO protocol elsewhere (the loaders stubbed out)."""
    from eas_snn_tpu.exp import EventExp as JEventExp

    from eas_snn_tpu_torch.exp import get_exp

    got = []
    for exp in (get_exp("gen4_rvt_syolox_m"), JEventExp()):
        exp.data_name, exp.eval_proph = data_name, True
        monkeypatch.setattr(exp, "get_data_loader",
                            lambda *a, **k: None, raising=False)
        ev = exp.get_evaluator(batch_size=2)
        got.append((type(ev).__name__, getattr(ev, "camera", None),
                    getattr(ev, "downsampled_by_2", None)))
    assert got[0] == got[1]
    assert got[0][1:] == (camera, ds2)


def _tiny(out, workers=0):
    return ["output_dir", out, "width", "0.125", "depth",
            "0.33", "compute_dtype", "float32", "data_num_workers",
            str(workers), "print_interval", "1", "max_epoch", "1", "seed",
            "1", "eval_interval", "1"]


@pytest.mark.parametrize("preset", ["ncaltech_syolox_m", "gen4"])
def test_entry_points_train_and_evaluate_new_datasets_on_the_cpu(
        tmp_path, preset):
    """The port's train and eval CLIs on an N-Caltech tree (the preset as
    it is, cut to size) and on a raw 1Mpx tree (``gen4_rvt_syolox_m`` with
    ``data_name gen4`` and ``Tl 1``: the raw reader stacks Tl windows,
    while the model takes one window of Tm micro-steps a label): two train
    steps, the epoch-end evaluation, then the eval CLI; for 1Mpx the
    Prophesee protocol with its box files, which the folder tool
    evaluates to the same AP."""
    from eas_snn_tpu_torch.tools import eval_event
    from eas_snn_tpu_torch.tools.train_event import build

    if preset == "gen4":
        data = str(tmp_path / "gen4")
        for split, seed in (("train", 0), ("val", 1)):
            write_gen4_tree(os.path.join(data, split), groups=3, seed=seed)
        opts = ["data_name", "gen4", "Tl", "1", "input_size", "(64, 96)",
                "test_size", "(64, 96)", "data_dir", data]
        name = "gen4_rvt_syolox_m"
    else:
        data = write_ncaltech_tree(str(tmp_path / "nc"))
        opts = ["input_size", "(64, 64)", "test_size", "(64, 64)",
                "data_dir", data]
        name = preset
    out = str(tmp_path / "out")
    exp, args = build(["-n", name, "-b", "2", "-l", "jsonl"] + _tiny(out)
                      + opts)
    exp.iters_per_epoch = 2
    tr = exp.get_trainer(args, device="cpu")
    tr.train()
    assert all(np.isfinite(v) for v in tr.last_losses.values())
    run = os.path.join(out, exp.exp_name)
    assert os.path.exists(os.path.join(run, "ckpt", "ckpt_2.pth"))
    assert any('"val"' in r for r in open(os.path.join(run,
                                                       "metrics.jsonl")))
    flags = ["-n", name, "-b", "2", "--device", "cpu", "-c",
             os.path.join(run, "ckpt", "ckpt_2.pth")]
    if preset == "gen4":
        flags += ["--eval_proh", "--save_boxes", str(tmp_path / "boxes")]
    res = eval_event.main(flags + _tiny(out) + opts)
    assert res["timing"]["samples"] == len(res["evaluator"].dataloader
                                           .dataset) > 0
    assert np.isfinite(res["ap"])
    if preset == "gen4":
        assert res["evaluator"].camera == "gen4"
        got = psee_evaluate_folders.main(
            ["--gt", str(tmp_path / "boxes" / "gt"), "--dt",
             str(tmp_path / "boxes" / "dt"), "--camera", "gen4"])
        assert (got["AP"], got["AP_50"]) == (res["ap"], res["ap50"])
    else:
        with pytest.raises(SystemExit, match="--eval_proh"):
            eval_event.build(flags + ["--save_boxes", "x"] + opts)


def test_no_aug_tail_closes_mosaic_where_the_dataset_has_it(tmp_path):
    """The trainer's no-aug tail calls the train dataset's ``close_mosaic``
    (a union forwards it to its children), as the JAX trainer does, and
    turns the L1 loss on."""
    from types import SimpleNamespace

    from eas_snn_tpu_torch.exp import get_exp

    exp = get_exp("gen1_syolox_s")
    exp.output_dir, exp.max_epoch, exp.no_aug_epochs = str(tmp_path), 2, 1
    tr = exp.get_trainer(device="cpu")
    union = pconcat.ConcatDataset([_Listed(2, "a"), _Listed(3, "b")])
    tr.train_loader = SimpleNamespace(dataset=union)
    tr.epoch = 0
    tr.before_epoch()
    assert not tr.use_l1 and not any(d.closed for d in union.datasets)
    tr.epoch = 1
    tr.before_epoch()
    assert tr.use_l1 and all(d.closed for d in union.datasets)
    tr.tracker.close()
