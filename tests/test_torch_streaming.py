"""The port's streaming detector against the JAX package's, on the CPU in
f32: device binning and the letterbox bit for bit, the rolling buffer,
``detect`` on the same weights and packets, the batch path on a shared
window, and the routing of the deploy forward at B=1 (the streaming
geometry) through the kernel wrappers' checks.

The detector is the one of ``tests/test_streaming.py``: a tiny spiking
model (width 0.125, T=Ts=2, an arsnn sampler of ksize 3) on a 48x64
sensor with a 32x64 input, Tm=3. Its weights are drawn with numpy into
the JAX model's variable shapes, with BN scales that make the spiking
stages fire (``test_torch_model._random_variables``), and cross to the
port through ``state_dict_from_jax``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from eas_snn_tpu.data.reps import bin_events_device as jbin_events_device
from eas_snn_tpu.inference import StreamingDetector as JStreamingDetector
from eas_snn_tpu.models import EASYOLOX as JEASYOLOX
from eas_snn_tpu.ops.boxes import postprocess_numpy

from eas_snn_tpu_torch.data import EVENT_DTYPE, bin_events_device, micro_sum
from eas_snn_tpu_torch.exp import get_exp
from eas_snn_tpu_torch.inference import StreamingDetector
from eas_snn_tpu_torch.models import EASYOLOX
from eas_snn_tpu_torch.ops import arsnn_fused as af
from eas_snn_tpu_torch.ops.boxes import postprocess
from eas_snn_tpu_torch.utils import state_dict_from_jax

from test_torch_model import _random_variables
from torch_meta import MetaAsCuda

IMG, INP, TM = (48, 64), (32, 64), 3
TINY = dict(num_classes=2, depth=0.33, width=0.125, use_spike="backbone",
            T=2, Ts=2, embedding="arsnn", embedding_ksize=3)
DET = dict(img_size=IMG, input_size=INP, Tm=TM, window_us=100_000,
           max_events=4096, num_classes=2, confthre=0.05, nmsthre=0.65)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def make_packet(rng, n, t0, t1, h=IMG[0], w=IMG[1]):
    ev = np.empty(n, EVENT_DTYPE)
    ev["t"] = np.sort(rng.integers(t0, t1, n))
    ev["x"] = rng.integers(0, w, n)
    ev["y"] = rng.integers(0, h, n)
    ev["p"] = rng.integers(0, 2, n)
    return ev


@pytest.fixture(scope="module")
def tiny():
    """The JAX model, its firing variables (obj / cls biases at 0 so that
    boxes pass the filter) and the port model with the same weights."""
    rng = np.random.default_rng(0)
    jm = JEASYOLOX(**TINY)
    ev = np.zeros((1, 1, TM) + INP + (2,), np.float32)
    v = _random_variables(jm, ev, rng)
    for k in range(3):
        for p in ("obj_pred", "cls_pred"):
            pred = v["params"]["head"][f"{p}{k}"]
            pred["bias"] = np.zeros_like(pred["bias"])
    pm = EASYOLOX(**TINY).eval()
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, v, pm


# ---------------------------------------------------------------- binning

def _binning_case(case: str, rng):
    """(t, x, y, p, valid, t0, tw, n_bins, H, W) int32 arrays of one
    case."""
    N, Tm, H, W = 3000, 4, 24, 40
    t = rng.integers(0, 50_000, N).astype(np.int32)
    x = rng.integers(0, W, N).astype(np.int32)
    y = rng.integers(0, H, N).astype(np.int32)
    p = rng.integers(0, 4, N).astype(np.int32)  # odd values: p & 1
    valid = np.ones(N, bool)
    t0, tw = 5_000, 11_000  # events before t0; b == 4 from t0 + 44,000
    if case == "padded":
        valid[rng.random(N) < 0.3] = False
        t[~valid] = 7  # a padded slot's fields are whatever was left
    elif case == "tw0":
        tw = 0  # max(tw, 1): bins one microsecond wide
        t = (t0 + rng.integers(-2, 6, N)).astype(np.int32)
    elif case == "sorted":
        t = np.sort(t)
        t0, tw = int(t[0]), (int(t[-1]) - int(t[0])) // Tm
    return t, x, y, p, valid, t0, tw, Tm, H, W


@pytest.mark.parametrize("case", ["plain", "padded", "tw0", "sorted"])
@pytest.mark.parametrize("tensor_scalars", [False, True])
def test_bin_events_device_equals_jax(case, tensor_scalars):
    """Bit-equal counts (adds of 1.0 below 2^24), t0 and tw as ints or as
    0-d device tensors (what a captured graph reads)."""
    t, x, y, p, v, t0, tw, Tm, H, W = _binning_case(
        case, np.random.default_rng(3))
    want = np.asarray(jbin_events_device(
        t, x, y, p, v, t0=t0, time_window=tw, n_bins=Tm, height=H,
        width=W))
    arg = (lambda s: torch.tensor(s)) if tensor_scalars else (lambda s: s)
    got = bin_events_device(*map(torch.from_numpy, (t, x, y, p, v)),
                            t0=arg(t0), time_window=arg(tw), n_bins=Tm,
                            height=H, width=W).numpy()
    assert got.shape == (Tm, H, W, 2)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < v.sum()  # some events fall outside


def test_bin_events_device_equals_micro_sum_at_gen1():
    """On one 200 ms Gen1 window (240x304, Tm=4), t0 the first event and
    tw (t_last - t_first) // 4 give ``micro_sum``'s frames, its dropped
    remainder included."""
    rng = np.random.default_rng(4)
    ev = make_packet(rng, 100_000, 1_000_000, 1_200_000, 240, 304)
    want = micro_sum(ev, 4, 240, 304)
    t0 = int(ev["t"][0])
    tw = (int(ev["t"][-1]) - t0) // 4
    f = (lambda k: torch.from_numpy(ev[k].astype(np.int64)))
    got = bin_events_device(f("t"), f("x"), f("y"), f("p"),
                            torch.ones(len(ev), dtype=torch.bool), t0=t0,
                            time_window=tw, n_bins=4, height=240,
                            width=304).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() < len(ev)


# -------------------------------------------------------------- letterbox

@pytest.mark.parametrize("img,inp", [((240, 304), (256, 320)),
                                     ((48, 64), (32, 64))])
def test_letterbox_equals_jax_nearest_resize(img, inp):
    """``F.interpolate(mode='nearest-exact')`` equals
    ``jax.image.resize(..., 'nearest')`` bit for bit: 240x304 -> 252x320
    (Gen1 into 256x320) and 48x64 -> 32x42; the detector's frames are
    those of the JAX detector's program on the same window."""
    scale = min(inp[0] / img[0], inp[1] / img[1])
    ih, iw = int(img[0] * scale), int(img[1] * scale)
    frames = np.random.default_rng(5).poisson(
        1.0, (4,) + img + (2,)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(frames),
                                       (4, ih, iw, 2), "nearest"))
    got = F.interpolate(torch.from_numpy(frames).permute(0, 3, 1, 2),
                        size=(ih, iw), mode="nearest-exact")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)

    rng = np.random.default_rng(6)
    ev = make_packet(rng, 20_000, 0, 100_000, *img)
    det = StreamingDetector(EASYOLOX(**TINY), **dict(
        DET, img_size=img, input_size=inp, max_events=32_768), device="cpu")
    det.push(ev)
    got = det.frames().numpy()
    t1 = int(ev["t"][-1]) + 1
    t0 = t1 - det.window_us
    span = int(ev["t"][-1]) - int(ev["t"][0])
    i32 = (lambda a: np.asarray(a, np.int32))  # as the JAX detect pads
    jf = jbin_events_device(
        i32(ev["t"].astype(np.int64) - t0), i32(ev["x"]), i32(ev["y"]),
        i32(ev["p"]), np.ones(len(ev), bool), t0=int(ev["t"][0]) - t0,
        time_window=max(span // TM, 1), n_bins=TM, height=img[0],
        width=img[1])
    want = jnp.zeros((TM,) + inp + (2,)).at[:, :ih, :iw].set(
        jax.image.resize(jf, (TM, ih, iw, 2), "nearest"))
    np.testing.assert_array_equal(got, np.asarray(want))


# ------------------------------------------------------------ push/detect

def _both(tiny, **kw):
    jm, v, pm = tiny
    return (JStreamingDetector(jm, v, **dict(DET, **kw)),
            StreamingDetector(pm, **dict(DET, **kw), device="cpu"))


def test_push_keeps_the_jax_window():
    """After the same packets the rolling buffers are equal."""
    jdet = JStreamingDetector(None, {}, **DET)
    pdet = StreamingDetector(EASYOLOX(**TINY), **DET, device="cpu")
    rng = np.random.default_rng(7)
    for k in range(6):
        pkt = make_packet(rng, 400, k * 40_000, (k + 1) * 40_000)
        jdet.push(pkt)
        pdet.push(pkt)
        np.testing.assert_array_equal(pdet._buf, jdet._buf)
    pdet.push(make_packet(rng, 0, 0, 1))
    assert int(pdet._buf["t"][0]) >= int(pdet._buf["t"][-1]) - 100_000


@pytest.mark.parametrize("max_events", [4096, 700])
def test_detect_matches_jax(tiny, max_events):
    """The port's ``detect`` (CPU, eager) against the JAX detector's on
    the same weights and packets: the decoded outputs before NMS within
    rtol 1e-5, atol 1e-4 (``test_whole_slice_matches_jax_f32``'s
    tolerance), the same number of kept boxes, the boxes within the same
    tolerance. With ``max_events`` 700 the window holds more events than
    the budget and both keep the newest."""
    jdet, pdet = _both(tiny, max_events=max_events)
    seen = []
    run = jdet._run
    jdet._run = lambda *a: seen.append(np.asarray(run(*a))) or seen[-1]
    rng = np.random.default_rng(8)
    for k in range(4):
        pkt = make_packet(rng, 500, k * 50_000, (k + 1) * 50_000)
        jdet.push(pkt)
        pdet.push(pkt)
    for t_now in (None, 160_000):
        want = jdet.detect(t_now)
        out = pdet.outputs(t_now)
        np.testing.assert_allclose(out, seen[-1], rtol=1e-5, atol=1e-4)
        got = pdet.detect(t_now)
        assert want is not None and got is not None
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    n_window = int(((pdet._buf["t"] >= pdet._buf["t"][-1] + 1 - 100_000)
                    ).sum())
    frames = pdet.frames()
    assert n_window > 700 or max_events == 4096
    if max_events == 700:  # the newest 700 of the window, binned
        assert 0 < float(frames.sum()) <= 700


def test_detect_of_an_empty_window_is_none(tiny):
    jdet, pdet = _both(tiny)
    assert pdet.detect() is None and pdet.outputs() is None
    pkt = make_packet(np.random.default_rng(9), 300, 0, 50_000)
    jdet.push(pkt)
    pdet.push(pkt)
    assert jdet.detect(t_now=10 ** 9) is None
    assert pdet.detect(t_now=10 ** 9) is None
    assert pdet.frames(t_now=10 ** 9) is None


def test_streaming_equals_the_batch_path_on_a_shared_window(tiny):
    """The streaming pipeline (device binning, nearest letterbox, forward,
    NMS, scale back) equals the port's batch path on the same window:
    ``micro_sum`` on the host, the same resize, ``exp.detect``'s forward
    and ``postprocess``."""
    _, _, pm = tiny
    pdet = StreamingDetector(pm, **DET, device="cpu")
    ev = make_packet(np.random.default_rng(10), 1500, 0, 100_000)
    pdet.push(ev)
    got = pdet.detect()
    frames = torch.from_numpy(micro_sum(ev, TM, *IMG))
    scale = min(INP[0] / IMG[0], INP[1] / IMG[1])
    ih, iw = int(IMG[0] * scale), int(IMG[1] * scale)
    fh = F.interpolate(frames.permute(0, 3, 1, 2), size=(ih, iw),
                       mode="nearest-exact")
    canvas = F.pad(fh, (0, INP[1] - iw, 0, INP[0] - ih)).permute(0, 2, 3, 1)
    with torch.no_grad():
        out = pm(canvas[None, None]).numpy()
    want = postprocess(out, 2, DET["confthre"], DET["nmsthre"])[0]
    assert got is not None and want is not None
    want[:, :4] /= scale
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, postprocess_numpy(out, 2, DET["confthre"], DET["nmsthre"])[0]
        * np.r_[[1 / scale] * 4, [1.0] * 3], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- B=1 routing

def test_deploy_forward_at_b1_passes_the_kernel_wrappers_checks(
        monkeypatch):
    """``detect``'s forward: ``gen1_syolox_m`` under ``deploy()`` at B=1,
    (1, 1, 4, 256, 320, 2). Every site passes the wrappers' layout checks
    and plans as at B=128 (the real wrappers on meta tensors with stub
    launches, ``tests/torch_meta.py``): 35 / 8 / 6 / 1 a forward; and the whole-scan sampler
    kernel takes N=1 (``v2_supported``; Tm launches a forward)."""
    from eas_snn_tpu_torch.ops import _build, launch_counts, reset_launches

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "get_lib", lambda name: Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(_build, "sm_count", lambda dev: 132)
    exp = get_exp("gen1_syolox_m").deploy()
    model = exp.get_model(device="cpu").to("meta")
    reset_launches()
    with MetaAsCuda():
        out = model(torch.empty((1, 1, 4, 256, 320, 2), device="meta"))
    counts = launch_counts()
    reset_launches()
    assert out.shape == (1, 1680, 7)
    assert counts == {"plif_fwd": 35, "conv1x1_plif": 8, "conv3x3_plif": 6,
                      "conv3x3s2_plif": 1, "plif_train_fwd": 0,
                      "plif_train_bwd": 0, "arsnn_v2": 0, "arsnn_step": 0}
    emb = model.embedding
    assert af.v2_supported(4, 2, 2, emb.depth, emb.ksize, Ts=emb.Ts, N=1)
    ev = torch.empty((4, 1, 2, 256, 320), device="meta")
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    assert emb.route(ev) == "v2"


# ---------------------------------------------------- the bench tool

def test_bench_stream_files_are_keyed_by_their_traffic(tmp_path):
    """``tools/bench_streaming.make_stream`` under one root at two rates
    writes two streams (the file is named by duration, rate and seed),
    each with its own rate's events; asking again for the first rate
    returns its file unchanged."""
    from eas_snn_tpu_torch.data import EventStream
    from eas_snn_tpu_torch.tools.bench_streaming import make_stream

    slow = make_stream(str(tmp_path), 500_000, 20_000)
    fast = make_stream(str(tmp_path), 500_000, 40_000)
    assert slow != fast
    n_slow, n_fast = (EventStream(d).event_count() for d in (slow, fast))
    assert (n_slow, n_fast) == (10_000, 20_000)
    stamp = tmp_path.joinpath(slow).stat().st_mtime_ns
    assert make_stream(str(tmp_path), 500_000, 20_000) == slow
    assert tmp_path.joinpath(slow).stat().st_mtime_ns == stamp
    assert EventStream(slow).event_count() == n_slow


def test_bench_paths_run_on_the_cpu(tmp_path):
    """Both protocols of the bench tool at three ticks on the CPU with a
    tiny model at ``gen1_syolox_m``'s input: the re-read baseline (its
    forward through ``CapturedProgram``, eager on the CPU) and the
    streaming detector; the summary holds finite ratios."""
    from eas_snn_tpu_torch.tools import bench_streaming as bs

    exp = get_exp("gen1_syolox_m")
    model = EASYOLOX(**TINY).eval()
    ticks = [300_000, 400_000, 500_000]
    dat = bs.make_stream(str(tmp_path), 700_000, 20_000)
    base = bs.baseline(exp, model, dat, ticks, bs.CONFTHRE,
                       torch.device("cpu"))
    det = StreamingDetector(model, img_size=bs.IMG_SIZE,
                            input_size=exp.test_size, Tm=exp.Tm,
                            window_us=200_000, max_events=8192,
                            device="cpu")
    strm = bs.stream(det, dat, ticks)
    assert len(base["total_s"]) == 3 and len(strm["total_s"]) == 2
    res = bs.summary(base, strm)
    assert np.isfinite([res["host_ratio"], res["total_ratio_p50"]]).all()
    assert det.replays == 0 and det.eager
