"""The port's Gen1 data path (``eas_snn_tpu_torch/data``) against the JAX
package's (``eas_snn_tpu/data``) on the same files and seeds: event IO,
the host representations and the device binning, the augmentation, the
Gen1 dataset in every mode, the samplers and the loader.

Tolerances: everything that is integer arithmetic, counting or a random
draw is bit-equal; the bilinear frame resize (the port's
``F.interpolate``, the JAX package's ``cv2.resize``, both half-pixel
INTER_LINEAR) agrees within RESIZE_TOL of |x| + 1: the two libraries round
the sampling weights differently (measured on an x86 CPU host: at most
7.2e-5 of |x| + 1, 1.3e-4 absolute, on Poisson counts at the Gen1 sensor
size).
"""

import filecmp
import itertools
import os

import numpy as np
import pytest
import torch

from eas_snn_tpu.data import augment as jaug
from eas_snn_tpu.data import loader as jloader
from eas_snn_tpu.data import psee_io as jio
from eas_snn_tpu.data import reps as jreps
from eas_snn_tpu.data.gen1 import Gen1Dataset as JGen1Dataset

from eas_snn_tpu_torch.data import augment as paug
from eas_snn_tpu_torch.data import loader as ploader
from eas_snn_tpu_torch.data import psee_io as pio
from eas_snn_tpu_torch.data import reps as preps
from eas_snn_tpu_torch.data import build_dataset
from eas_snn_tpu_torch.data.gen1 import Gen1Dataset as PGen1Dataset

RESIZE_TOL = 2e-4
SENSOR = (240, 304)


def _events(rng, n, duration=400_000, hw=SENSOR):
    t = np.sort(rng.integers(0, duration, n))
    return (t, rng.integers(0, hw[1], n), rng.integers(0, hw[0], n),
            rng.integers(0, 2, n))


def write_tree(root, streams=2, groups=6, n_events=6000, seed=0):
    """A small Gen1 directory written with the JAX package's writers."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for s in range(streams):
        dur = 300_000 + groups * 50_000
        jio.write_dat_events(os.path.join(root, f"seq{s}_td.dat"),
                             *_events(rng, n_events, dur))
        rows = []
        for k in range(groups):
            for j in range(int(rng.integers(1, 4))):
                w, h = rng.uniform(10, 90), rng.uniform(10, 70)
                rows.append((250_000 + 50_000 * k, rng.uniform(0, 304 - w),
                             rng.uniform(0, 240 - h), w, h,
                             int(rng.integers(0, 2)), j, 1.0))
        jio.write_bboxes_npy(os.path.join(root, f"seq{s}_bbox.npy"), rows)
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("gen1")))


# ------------------------------------------------------------- psee_io

def test_writers_write_the_jax_bytes_and_readers_agree(tmp_path):
    rng = np.random.default_rng(1)
    ev = _events(rng, 5000)
    rows = [(100, 1.5, 2.5, 30.0, 20.0, 1, 7, 0.9),
            (100, 50.0, 60.0, 10.0, 12.0, 0, 8, 1.0),
            (250, 5.0, 6.0, 7.0, 8.0, 1, 9, 0.5)]
    for mod, tag in ((jio, "j"), (pio, "p")):
        mod.write_dat_events(str(tmp_path / f"{tag}_td.dat"), *ev)
        mod.write_bboxes_npy(str(tmp_path / f"{tag}_bbox.npy"), rows)
    assert filecmp.cmp(tmp_path / "j_td.dat", tmp_path / "p_td.dat",
                       shallow=False)
    assert filecmp.cmp(tmp_path / "j_bbox.npy", tmp_path / "p_bbox.npy",
                       shallow=False)
    assert pio.EVENT_DTYPE == jio.EVENT_DTYPE
    assert pio.BBOX_DTYPE == jio.BBOX_DTYPE
    for tag in ("j", "p"):
        js = jio.EventStream(str(tmp_path / f"{tag}_td.dat"))
        ps = pio.EventStream(str(tmp_path / f"{tag}_td.dat"))
        assert ps.get_size() == js.get_size() == (240, 304)
        np.testing.assert_array_equal(ps.events_between(1000, 200_000),
                                      js.events_between(1000, 200_000))
        for s in (js, ps):
            s.seek_time(50_000)
        np.testing.assert_array_equal(ps.load_delta_t(30_000),
                                      js.load_delta_t(30_000))
        assert ps.current_time == js.current_time
        np.testing.assert_array_equal(
            pio.load_bboxes(str(tmp_path / f"{tag}_bbox.npy")),
            jio.load_bboxes(str(tmp_path / f"{tag}_bbox.npy")))


# ---------------------------------------------------------------- reps

def _decoded(rng, n, hw=SENSOR):
    ev = np.zeros(n, pio.EVENT_DTYPE)
    t, x, y, p = _events(rng, n, hw=hw)
    ev["t"], ev["x"], ev["y"], ev["p"] = t, x, y, p
    return ev


@pytest.mark.parametrize("native", [True, False])
def test_host_reps_equal_jax_bitwise(native):
    rng = np.random.default_rng(2)
    for n in (0, 1, 3, 20_000):
        ev = _decoded(rng, n)
        np.testing.assert_array_equal(
            preps.polarity_histogram(ev, 240, 304, native=native),
            jreps.polarity_histogram(ev, 240, 304))
        np.testing.assert_array_equal(
            preps.micro_sum(ev, 4, 240, 304, native=native),
            jreps.micro_sum(ev, 4, 240, 304))
        ps, pstride = preps.slice_time_windows(ev, 4)
        js, jstride = jreps.slice_time_windows(ev, 4)
        assert pstride == jstride
        for a, b in zip(ps, js):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    ev = _decoded(rng, 5000)
    for got, want in zip(preps.pad_events(ev, 4096),
                         jreps.pad_events(ev, 4096)):
        np.testing.assert_array_equal(got, want)


def test_native_core_takes_wide_fields_that_fit():
    """int64 fields that fit the core's u16/u16/u8 layout go through it;
    a value that would wrap falls to numpy, which raises on it."""
    rng = np.random.default_rng(3)
    ev = _decoded(rng, 1000)
    wide = np.zeros(len(ev), [("t", "<i8"), ("x", "<i8"), ("y", "<i8"),
                              ("p", "<i8")])
    for k in ("t", "x", "y", "p"):
        wide[k] = ev[k]
    assert preps._native_xyp(wide) is not None
    np.testing.assert_array_equal(preps.micro_sum(wide, 4, 240, 304),
                                  jreps.micro_sum(ev, 4, 240, 304))
    wide["x"][0] = -1
    assert preps._native_xyp(wide) is None


def test_bin_event_batch_equals_jax_bitwise():
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    B, Tl, N, Tm, H, W = 3, 2, 4096, 4, 24, 40
    b = rng.integers(0, Tm, (B, Tl, N)).astype(np.int32)
    x = rng.integers(0, W, (B, Tl, N)).astype(np.int32)
    y = rng.integers(0, H, (B, Tl, N)).astype(np.int32)
    p = rng.integers(0, 2, (B, Tl, N)).astype(np.int32)
    valid = rng.uniform(size=(B, Tl, N)) < 0.7
    valid[1, 0, 100:] = False  # a padded tail
    got = preps.bin_event_batch(*(torch.from_numpy(a) for a in
                                  (b, x, y, p, valid)),
                                n_bins=Tm, height=H, width=W)
    want = jreps.bin_event_batch(*(jnp.asarray(a) for a in
                                   (b, x, y, p, valid)),
                                 n_bins=Tm, height=H, width=W)
    assert got.shape == (B, Tl, Tm, H, W, 2) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = preps.bin_event_batch(
        *(torch.from_numpy(a[1, 0]) for a in (b, x, y, p, valid)),
        n_bins=Tm, height=H, width=W)
    np.testing.assert_array_equal(one.numpy(), np.asarray(
        jreps.bin_indexed_events_device(
            *(jnp.asarray(a[1, 0]) for a in (b, x, y, p, valid)),
            n_bins=Tm, height=H, width=W)))


# ------------------------------------------------------------- augment

def _close_frames(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_less(np.abs(got - want),
                                 RESIZE_TOL * (1.0 + np.abs(want)) + 1e-12)


@pytest.mark.parametrize("dsize", [(288, 227), (320, 256), (100, 70),
                                   (33, 21), (304, 240)])
def test_resize_frames_matches_cv2(dsize):
    rng = np.random.default_rng(5)
    frames = rng.poisson(0.4, (4, 240, 304, 2)).astype(np.float32)
    _close_frames(paug.resize_frames(frames, dsize),
                  jaug.resize_frames(frames, dsize))


def test_augmentation_draws_and_boxes_equal_jax():
    rng = np.random.default_rng(6)
    frames = rng.poisson(0.3, (4, 240, 304, 2)).astype(np.float32)
    boxes = np.array([[10, 20, 60, 80, 1], [100, 50, 200, 150, 0],
                      [290, 200, 303, 239, 1]], np.float32)
    for seed in range(6):
        jr, pr = np.random.default_rng(seed), np.random.default_rng(seed)
        jf, jb = jaug.random_resize_place_flip(frames, boxes, (256, 320), jr,
                                               flip_prob=0.5)
        pf, pb = paug.random_resize_place_flip(frames, boxes, (256, 320), pr,
                                               flip_prob=0.5)
        np.testing.assert_array_equal(pb, jb)
        _close_frames(pf, jf)
        assert jr.uniform() == pr.uniform()  # the same draws, consumed
        # the same placement and flip, drawn as an affine
        assert paug.sample_affine((240, 304), (256, 320),
                                  np.random.default_rng(seed)) == \
            jaug.sample_affine((240, 304), (256, 320),
                               np.random.default_rng(seed))
    jf, jb = jaug.letterbox(frames, boxes, (256, 320))
    pf, pb = paug.letterbox(frames, boxes, (256, 320))
    np.testing.assert_array_equal(pb, jb)
    _close_frames(pf, jf)


# ---------------------------------------------------------------- Gen1

_KW = dict(aggregation="micro_sum", overlap=0, num_slice=1, micro_slice=4,
           measure="count", window=(-200_000, 0), max_labels=50,
           max_events_per_slice=4096)


def _pair(tree, **kw):
    kw = dict(_KW, **kw)
    return (JGen1Dataset(tree, input_size=(64, 96), **kw),
            PGen1Dataset(tree, input_size=(64, 96), **kw))


@pytest.mark.parametrize("mode", ["train", "val", "map_val"])
def test_gen1_samples_equal_jax(tree, mode):
    train = mode == "train"
    jd, pd = _pair(tree, training=train, map_val=mode == "map_val",
                   flip_prob=0.5 if train else 0.0)
    assert len(pd) == len(jd) == 12
    assert pd.sample_names == jd.sample_names
    for i in (0, 5, 11, 3):
        jf, jl, js, jid = jd[i]
        pf, pl, ps, pid = pd[i]
        _close_frames(pf, jf)
        np.testing.assert_array_equal(pl, jl)
        assert tuple(ps) == tuple(js) and pid == jid
    assert pd.profile["count"] == 4


def test_gen1_raw_samples_equal_jax(tree):
    jd, pd = _pair(tree, training=True, map_val=False, raw_events=True,
                   flip_prob=0.5)
    for i in (0, 7, 2):
        (jev, jl, js, jid), (pev, pl, ps, pid) = jd[i], pd[i]
        for a, b in zip(pev, jev):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pl, jl)
        assert pid == jid


def test_build_dataset_reads_gen1_and_refuses_the_rest(tree):
    """gen1 is read; names the JAX package does not know and unknown
    aggregations are refused. (The other datasets, aggregations and the
    frame cache are held to the JAX package in test_torch_datasets.py.)"""
    ds = build_dataset("gen1", tree, input_size=(64, 96), **_KW)
    assert isinstance(ds, PGen1Dataset) and len(ds) == 12
    for name in ("coco", "gen2", ""):
        with pytest.raises(KeyError, match="unknown dataset"):
            build_dataset(name, tree)
    vg = build_dataset("gen1", tree, input_size=(64, 96),
                       **dict(_KW, aggregation="voxel_grid"))
    assert vg[0][0].shape == (1, 4, 64, 96, 1)
    bad = build_dataset("gen1", tree, input_size=(64, 96),
                        **dict(_KW, aggregation="histogram"))
    with pytest.raises(ValueError, match="unknown aggregation"):
        bad[0]
    cached = build_dataset("gen1", tree, training=False, cache_path="ram",
                           input_size=(64, 96), **_KW)
    first = cached[3][0]
    assert len(cached._frame_cache) == 1
    np.testing.assert_array_equal(cached[3][0], first)
    with pytest.raises(IndexError):
        ds[12]


# ------------------------------------------------------------- samplers

@pytest.mark.parametrize("seed,rank,world,shuffle", [
    (0, 0, 1, True), (3, 1, 2, True), (7, 2, 4, True), (5, 1, 3, False)])
def test_samplers_give_the_jax_index_stream(seed, rank, world, shuffle):
    kw = dict(shuffle=shuffle, seed=seed, rank=rank, world_size=world)
    got = list(itertools.islice(iter(ploader.InfiniteSampler(13, **kw)), 60))
    want = list(itertools.islice(iter(jloader.InfiniteSampler(13, **kw)),
                                 60))
    assert got == [int(i) for i in want]
    ps = ploader.SequentialSampler(13, rank=rank, world_size=world)
    js = jloader.SequentialSampler(13, rank=rank, world_size=world)
    assert list(ps) == list(js) and len(ps) == len(js)


# --------------------------------------------------------------- loader

def test_loader_batches_and_collate(tree):
    ds = build_dataset("gen1", tree, input_size=(64, 96), **_KW)
    ld = ploader.EventDataLoader(ds, batch_size=3, num_workers=0, seed=4)
    frames, labels, sizes, ids = next(iter(ld))
    assert frames.shape == (3, 1, 4, 64, 96, 2)
    assert frames.dtype == torch.float32
    assert labels.shape == (3, 50, 5) and labels.dtype == torch.float32
    assert sizes.tolist() == [[240, 304]] * 3
    with pytest.raises(TypeError):
        len(ld)
    val = build_dataset("gen1", tree, training=False, map_val=True,
                        input_size=(64, 96), **_KW)
    vl = ploader.EventDataLoader(val, batch_size=5, infinite=False,
                                 shuffle=False, num_workers=0)
    batches = list(vl)
    assert len(vl) == len(batches) == 3
    assert isinstance(batches[0][1], list) and batches[-1][0].shape[0] == 2
    assert torch.cat([b[3] for b in batches]).tolist() == list(range(12))


def test_loader_workers_reseed_as_jax(tree):
    """Two spawned workers: batch k comes from worker k % 2, whose dataset
    generator is seeded ``seed + 1000 * (wid + 1)``; the augmentation of
    each batch equals a dataset copy seeded that way."""
    ds = build_dataset("gen1", tree, input_size=(64, 96), flip_prob=0.5,
                       **_KW)
    seed = 9
    ld = ploader.EventDataLoader(ds, batch_size=2, num_workers=2, seed=seed)
    assert ploader.worker_seed(seed, 0) == 1009
    assert ploader.worker_seed(seed, 1) == 2009
    it = iter(ld)
    got = [next(it) for _ in range(2)]
    order = list(itertools.islice(iter(ploader.InfiniteSampler(
        len(ds), seed=seed)), 4))
    for wid in range(2):
        ref = build_dataset("gen1", tree, input_size=(64, 96),
                            flip_prob=0.5, **_KW)
        ref.rng = np.random.default_rng(seed + 1000 * (wid + 1))
        for j in range(2):
            _, lab, _, sid = ref[order[2 * wid + j]]
            np.testing.assert_array_equal(got[wid][1][j].numpy(), lab)
            assert int(got[wid][3][j]) == sid
    assert not torch.equal(got[0][1], got[1][1])
    del it, ld


def test_prefetcher_passes_batches_through_on_the_cpu():
    batches = [(torch.full((2, 3), float(i)), [torch.ones(1)])
               for i in range(3)]
    got = list(ploader.DevicePrefetcher(iter(batches), "cpu"))
    assert len(got) == 3
    for (a, b), (c, d) in zip(got, batches):
        assert a is c and b[0] is d[0]
