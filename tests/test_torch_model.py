"""The port's modules and the whole eval slice against the JAX package, on
the CPU in f32 with the same weights, plus its weights bridge and its
no-JAX rule.

The whole-slice weights are drawn with numpy from a seed into the JAX
model's variable shapes (``jax.eval_shape`` of its init), with BN
parameters and statistics and PLIF decays chosen so that the spiking
stages fire (at an identity BN dark3-dark5 stay silent and a comparison
would prove nothing). The port receives the same tree through
``state_dict_from_jax``. The JAX side runs under ``jax.jit``.
"""

import functools
import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eas_snn_tpu.models import EASYOLOX as JEASYOLOX
from eas_snn_tpu.models.blocks import BaseConv as JBaseConv
from eas_snn_tpu.models.blocks import NeuronCfg
from eas_snn_tpu.models.embedding import ARSNNEmbedding as JARSNNEmbedding
from eas_snn_tpu.ops import conv_plif_pallas as jcp
from eas_snn_tpu.ops.boxes import postprocess_numpy
from eas_snn_tpu.utils.torch_import import translate_torch_checkpoint

from chip_smoke import calibrate_spiking_bn
from eas_snn_tpu_torch.exp import detect, get_exp
from eas_snn_tpu_torch.models import ARSNNEmbedding, BaseConv, EASYOLOX, Neuron
from eas_snn_tpu_torch.models import blocks as pblocks
from eas_snn_tpu_torch.utils import (load_reference_state_dict,
                                     state_dict_from_jax)
from torch_meta import MetaAsCuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 3
# the flagship recipe at a small size
SMALL = dict(num_classes=2, depth=0.33, width=0.125, T=T, spike_fn="atan",
             embedding_ksize=5, embedding_depth=2, Ts=3, readout="sum",
             write_zero=True, thresh=1.0, vreset=None)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _random_variables(model, ev, rng):
    """Variables of the JAX ``model`` at its init's shapes, drawn with
    numpy: conv kernels (HWIO) N(0, 1/fan_in), everything else zero, BN
    statistics the identity, then redrawn by :func:`_firing_bn`."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(ev))

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        if leaf.ndim == 4:
            fan_in = int(np.prod(leaf.shape[:3]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(np.float32)
        fill = 1.0 if name == "var" else 0.0
        return np.full(leaf.shape, fill, np.float32)

    v = jax.tree_util.tree_map_with_path(draw, dict(shapes))
    return _firing_bn({k: v[k] for k in ("params", "batch_stats")}, rng)


def _firing_bn(variables, rng):
    """Redraw every BN's scale/bias/mean/var (and each PLIF w) so that the
    folded weights are not the identity and the spiking sites fire."""
    v = _np_tree(variables)

    def walk(p, s):
        if "bn" in p:
            C = p["bn"]["scale"].shape[0]
            spiking = "PLIF_0" in p
            lo, hi = (1.5, 2.5) if spiking else (0.8, 1.2)
            p["bn"]["scale"] = rng.uniform(lo, hi, C).astype(np.float32)
            p["bn"]["bias"] = rng.uniform(-0.2, 0.3, C).astype(np.float32)
            s["bn"]["mean"] = rng.normal(0, 0.1, C).astype(np.float32)
            s["bn"]["var"] = rng.uniform(0.5, 1.5, C).astype(np.float32)
            if spiking:
                p["PLIF_0"]["w"] = np.float32(rng.uniform(-1, 1))
        for k in p:
            if isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])

    walk(v["params"], v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def small():
    """The JAX model at the small size, its firing variables
    (params and batch_stats) and a batch of events."""
    rng = np.random.default_rng(0)
    ev = rng.poisson(0.2, (2, 1, 4, 64, 64, 2)).astype(np.float32)
    jm = JEASYOLOX(use_spike="backbone", embedding="arsnn", **SMALL)
    return jm, _random_variables(jm, ev, rng), ev


def _port(model_vars, **kw):
    m = EASYOLOX(use_spike="backbone", **{**SMALL, **kw}).eval()
    m.load_state_dict(state_dict_from_jax(model_vars), strict=True)
    return m


# --------------------------------------------------------------- modules

def test_arsnn_embedding_matches_jax_f32():
    rng = np.random.default_rng(0)
    # dense enough events that all Ts=3 slots get written somewhere
    ev = rng.poisson(1.0, (2, 1, 4, 32, 40, 2)).astype(np.float32)
    je = JARSNNEmbedding(ksize=5, depth=2, Ts=3, readout="sum",
                         write_zero=True, thresh=1.0, vreset=None)
    v = _np_tree(jax.jit(je.init)(jax.random.PRNGKey(0), jnp.asarray(ev)))
    want = np.asarray(jax.jit(je.apply)(v, jnp.asarray(ev)))  # (Ts,N,H,W,C)
    pe = ARSNNEmbedding(ksize=5, depth=2, Ts=3, readout="sum",
                        write_zero=True, thresh=1.0, vreset=None).eval()
    sd = state_dict_from_jax({"params": {"embedding": v["params"]}})
    pe.load_state_dict({k[len("embedding."):]: t for k, t in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = pe(torch.from_numpy(ev)).permute(0, 1, 3, 4, 2).numpy()
    assert got.shape == want.shape == (3, 2, 32, 40, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # every slot is written somewhere: the sampler really segments time
    assert all((want[s] != 0).mean() > 0.01 for s in range(3))


def test_baseconv_fused_3x3_site_equals_jax_reference():
    """The port's BaseConv, forced to fuse by its policy argument, equals
    the JAX conv3x3_plif_reference on the JAX-folded weights. Quarter-
    valued kernel and scale with var + eps == 1 keep every sum exact."""
    rng = np.random.default_rng(6)
    Cin, Cout, B = 16, 24, 2
    x = rng.integers(0, 2, (T * B, 6, 5, Cin)).astype(np.int8)
    kernel = (rng.integers(-2, 3, (3, 3, Cin, Cout)) * 0.25).astype(np.float32)
    scale = (rng.integers(2, 7, Cout) * 0.25).astype(np.float32)
    beta = (rng.integers(-2, 3, Cout) * 0.25).astype(np.float32)
    mean = (rng.integers(-2, 3, Cout) * 0.125).astype(np.float32)
    var = np.full(Cout, np.float32(1.0) - np.float32(1e-3), np.float32)
    wp = np.float32(-0.5)

    conv = BaseConv(Cin, Cout, 3, 1, neuron=Neuron(True, T, fuse="always"),
                    dtype=torch.bfloat16).eval()
    with torch.no_grad():
        conv.conv[0].weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        conv.bn.weight.copy_(torch.from_numpy(scale))
        conv.bn.bias.copy_(torch.from_numpy(beta))
        conv.bn.running_mean.copy_(torch.from_numpy(mean))
        conv.bn.running_var.copy_(torch.from_numpy(var))
        conv.act.w.fill_(float(wp))
        got = conv(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert got.dtype == torch.int8

    mul = jax.lax.rsqrt(jnp.asarray(var) + 1e-3) * scale
    w3 = jcp.fold_conv3x3(jnp.asarray(kernel), mul)
    want = jcp.conv3x3_plif_reference(
        jnp.asarray(x), w3, jnp.asarray(beta) - jnp.asarray(mean) * mul, T,
        jnp.asarray(wp))
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(want))
    assert 0.05 < float(np.asarray(want, np.float32).mean()) < 0.95


def test_jax_baseconv_unfused_spiking_site_matches_port():
    """The unfused chain conv -> BN -> PLIF in f32, port vs JAX."""
    rng = np.random.default_rng(7)
    Cin, Cout, B = 8, 16, 2
    x = rng.integers(0, 2, (T * B, 6, 6, Cin)).astype(np.float32)
    jc = JBaseConv(Cout, 3, 2, neuron=NeuronCfg.snn(T))
    v = _np_tree(jc.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    v["params"]["bn"]["scale"] = np.full(Cout, 2.5, np.float32)
    want = np.asarray(jc.apply(v, jnp.asarray(x)))
    pc = BaseConv(Cin, Cout, 3, 2, neuron=Neuron(True, T, fuse="never")).eval()
    pc.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = pc(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)
    assert 0.05 < want.mean() < 0.95


# ------------------------------------------------------------ whole slice

def test_whole_slice_matches_jax_f32(small):
    """EASYOLOX eval forward (use_spike='backbone'), then detect. Both
    sides run unfused (no flagship policy key matches 64x64). Tolerance:
    the spikes agree exactly; the decoded outputs (up to ~60 in value)
    differ only by f32 rounding, as XLA and oneDNN sum the analog convs
    in different orders and exp() of the box size amplifies it, so
    atol 1e-4 / rtol 1e-5 (about 25x the deviation seen)."""
    jm, v, ev = small
    # obj and cls biases at 0 so that detections pass the filter
    v = jax.tree_util.tree_map(np.copy, v)
    for k in range(3):
        for p in ("obj_pred", "cls_pred"):
            pred = v["params"]["head"][f"{p}{k}"]
            pred["bias"] = np.zeros_like(pred["bias"])
    apply = jax.jit(functools.partial(
        jm.apply, mutable=["intermediates"],
        capture_intermediates=lambda m, _: type(m).__name__ == "CSPDarknet"))
    want, st = apply(v, jnp.asarray(ev))
    want = np.asarray(want)
    jfeats = st["intermediates"]["backbone"]["backbone"]["__call__"][0]

    pm = _port(v)
    feats = {}
    pm.backbone.backbone.register_forward_hook(lambda m, i, o: feats.update(o))
    with torch.no_grad():
        got = pm(torch.from_numpy(ev)).numpy()
    assert got.shape == want.shape == (2, 84, 7)
    for stage in ("dark3", "dark4", "dark5"):
        s_j = np.asarray(jfeats[stage])
        s_p = feats[stage].permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(s_p, s_j)
        assert 0.02 < s_j.mean() < 0.6, stage
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    dets = detect(pm, torch.from_numpy(ev), conf_thre=0.2, nms_thre=0.65)
    jdets = postprocess_numpy(want, 2, 0.2, 0.65)
    for d, jd in zip(dets, jdets):
        assert d is not None and jd is not None and len(d) == len(jd) > 0
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)


def test_use_spike_none_and_unported_modes(small):
    """The analog model is the spiking one's tree without the PLIF decays,
    its BN redrawn at analog scales (the spiking scales, up to 2.5 at each
    of ~40 layers, would overflow the box decode's exp). The 'full' modes,
    once refused here, run now: ``tests/test_torch_variants_model.py``
    holds every mode against the JAX package."""
    _, v, ev = small

    def drop_plif(tree):
        return {k: drop_plif(t) if isinstance(t, dict) else t
                for k, t in tree.items() if k != "PLIF_0"}

    v = _firing_bn({"params": drop_plif(v["params"]),
                    "batch_stats": v["batch_stats"]}, np.random.default_rng(1))
    jm = JEASYOLOX(use_spike="none", embedding="arsnn", **SMALL)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(ev[:1])))
    pm = EASYOLOX(use_spike="none", **SMALL).eval()
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(ev[:1])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_flagship_site_routing_per_forward(monkeypatch):
    """At the flagship geometry (gen1_syolox_m, 256x320) one forward sends
    35 sites to the PLIF kernel, 8 to conv1x1, 6 to conv3x3 and 1 to
    conv3x3s2. Shapes only: the model runs on the meta device with the
    kernel wrappers replaced by counters."""
    calls = {"plif": 0, "c1": 0, "c3": 0, "c3s2": 0}

    def fake(name, out):
        def f(x, *a, **k):
            calls[name] += 1
            return out(x, *a)
        return f

    def first(x):
        return x[0] if isinstance(x, (tuple, list)) else x

    monkeypatch.setattr(pblocks, "plif_forward", fake(
        "plif", lambda x, *a: torch.empty(x.shape, dtype=torch.int8,
                                          device=x.device)))
    monkeypatch.setattr(pblocks, "conv1x1_plif", fake(
        "c1", lambda x, w, *a: torch.empty(
            (first(x).shape[0], w.shape[0]) + tuple(first(x).shape[2:]),
            dtype=torch.int8, device=first(x).device)))
    for name, s in (("conv3x3_plif", 1), ("conv3x3s2_plif", 2)):
        monkeypatch.setattr(pblocks, name, fake(
            "c3" if s == 1 else "c3s2", lambda x, w, *a, s=s: torch.empty(
                (x.shape[0], w.shape[1], x.shape[2] // s, x.shape[3] // s),
                dtype=torch.int8, device=x.device)))
    exp = get_exp("gen1_syolox_m").deploy()
    model = exp.get_model(device="cpu").to("meta")
    out = model(torch.empty((1, 1, 4, 256, 320, 2), device="meta"))
    assert out.shape == (1, 1680, 7)
    assert calls == {"plif": 35, "c1": 8, "c3": 6, "c3s2": 1}


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_flagship_sites_pass_the_kernel_wrappers_checks(monkeypatch, compute):
    """The kernels take only layouts that split into whole aligned copies,
    and their wrappers raise otherwise. Every flagship site (deploy's bf16
    and the f32 of the card-vs-CPU check) must pass those checks: the real
    wrappers run on meta tensors, as on the card (``tests/torch_meta.py``),
    with the library's entry points replaced by stubs that launch
    nothing."""
    from eas_snn_tpu_torch.ops import _build, launch_counts, reset_launches

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "get_lib", lambda name: Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    exp = get_exp("gen1_syolox_m").deploy()
    exp.compute_dtype = compute
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


def test_flagship_train_step_sites_pass_the_train_kernels_checks(
        monkeypatch):
    """One train step of the flagship (gen1_syolox_m, 256x320, bf16) on
    meta tensors, as on the card: every one of the 50 spiking sites passes
    the train kernels' layout checks, and a step launches each train
    kernel once a site (the library replaced by stubs), no eval kernel."""
    from eas_snn_tpu_torch.ops import _build, launch_counts, reset_launches

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "get_lib", lambda name: Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    model = get_exp("gen1_syolox_m").get_model(device="cpu",
                                               train=True).to("meta")
    ev = torch.empty((1, 1, 4, 256, 320, 2), device="meta")
    labels = torch.zeros((1, 50, 5), device="meta")
    reset_launches()
    losses = model(ev, labels)
    losses["total_loss"].backward()
    counts = launch_counts()
    reset_launches()
    assert counts == {"plif_fwd": 0, "conv1x1_plif": 0, "conv3x3_plif": 0,
                      "conv3x3s2_plif": 0, "plif_train_fwd": 50,
                      "plif_train_bwd": 50, "arsnn_v2": 0, "arsnn_step": 0}
    assert all(p.grad is not None for p in model.parameters())


@pytest.mark.parametrize("name,overrides", [
    ("ncaltech_syolox_m", []),
    ("gen4_rvt_syolox_m", ["data_name", "gen4", "Tl", "1"])])
def test_new_presets_train_step_sites_pass_the_train_kernels_checks(
        monkeypatch, name, overrides):
    """One train step of the N-Caltech (640x640, 100 classes) and the raw
    1Mpx (384x640, Tl 1) presets on meta tensors, as
    ``test_flagship_train_step_sites_pass_the_train_kernels_checks``: all
    50 spiking sites pass the train kernels' checks, 50 + 50 launches."""
    from eas_snn_tpu_torch.ops import _build, launch_counts, reset_launches

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "get_lib", lambda name: Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    exp = get_exp(name).merge(overrides)
    model = exp.get_model(device="cpu", train=True).to("meta")
    H, W = exp.input_size
    ev = torch.empty((1, exp.Tl, exp.Tm, H, W, 2), device="meta")
    reset_launches()
    losses = model(ev, torch.zeros((1, 50, 5), device="meta"))
    losses["total_loss"].backward()
    counts = launch_counts()
    reset_launches()
    assert counts == {k: {"plif_train_fwd": 50, "plif_train_bwd": 50}.get(
        k, 0) for k in counts}


def _jax_preset(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "exps", "default", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Exp()


def test_ncaltech_preset_fields_equal_the_jax_exp():
    """``get_exp('ncaltech_syolox_m')`` holds every field it shares with
    ``exps/default/ncaltech_syolox_m.py``'s Exp, at the same value."""
    jexp, pexp = _jax_preset("ncaltech_syolox_m"), get_exp(
        "ncaltech_syolox_m")
    shared = set(vars(jexp)) & set(vars(pexp))
    assert {"alpha", "window", "Tl", "Tm", "Ts", "T", "num_classes",
            "speed_aug", "data_name", "eval_interval"} <= shared
    assert len(shared) >= 59
    for f in sorted(shared):
        assert getattr(pexp, f) == getattr(jexp, f), f
    assert (pexp.alpha, pexp.window, pexp.Tl, pexp.Tm, pexp.Ts, pexp.T) == (
        1.5, 0, 1, 4, 3, 3)


def test_narrow_ncaltech_forward_matches_jax():
    """The N-Caltech preset's model cut to depth 0.33, width 0.125 and
    64x64 in f32, port against JAX from the same drawn weights: the
    eval forward's decoded outputs over 100 classes, with the tolerance of
    ``test_whole_slice_matches_jax_f32``."""
    over = dict(depth=0.33, width=0.125, input_size=(64, 64),
                test_size=(64, 64), compute_dtype="float32")
    jexp, pexp = _jax_preset("ncaltech_syolox_m"), get_exp(
        "ncaltech_syolox_m")
    for e in (jexp, pexp):
        for k, val in over.items():
            setattr(e, k, val)
    jm = jexp.get_model()
    rng = np.random.default_rng(4)
    ev = rng.poisson(0.2, (2, 1, 4, 64, 64, 2)).astype(np.float32)
    v = jax.tree_util.tree_map(np.copy, _random_variables(jm, ev, rng))
    for k in range(3):
        for p in ("obj_pred", "cls_pred"):
            pred = v["params"]["head"][f"{p}{k}"]
            pred["bias"] = np.zeros_like(pred["bias"])
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(ev)))
    pm = pexp.get_model(device="cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(ev)).numpy()
    assert got.shape == want.shape == (2, 84, 105)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (want[..., 4] > 0.01).mean() > 0.1


def test_calibrate_spiking_bn_makes_every_stage_fire():
    """At the JAX init (identity BN) the deep stages of a random network
    fall silent; calibrated BN statistics make each fire near 20%."""
    m = EASYOLOX(use_spike="backbone", **SMALL).eval()
    m.reset_parameters(torch.Generator().manual_seed(0))
    ev = torch.poisson(torch.full((2, 1, 4, 64, 64, 2), 0.2),
                       generator=torch.Generator().manual_seed(0))
    calibrate_spiking_bn(m, ev)
    feats = {}
    m.backbone.backbone.register_forward_hook(lambda _, i, o: feats.update(o))
    m(ev)
    for stage in ("dark3", "dark4", "dark5"):
        assert 0.1 < feats[stage].float().mean() < 0.3, stage
    site = m.backbone.backbone.dark2[0]
    assert torch.all(site.bn.weight == 1) and torch.all(site.bn.bias == 0)
    assert torch.all(site.bn.running_var > 0)


# ----------------------------------------------------------------- weights

def test_state_dict_round_trip_through_jax_importer(small):
    """JAX variables -> port state dict -> the JAX package's own importer
    gives back the same variables exactly, with nothing unmapped."""
    _, v, _ = small
    pm = _port(v)
    sd = {k: t.numpy() for k, t in pm.state_dict().items()}
    zeros = jax.tree_util.tree_map(np.zeros_like, v)
    back, report = translate_torch_checkpoint(sd, zeros)
    assert report["unmapped"] == 0 and report["shape_miss"] == 0, report
    assert report["mapped"] == len(jax.tree_util.tree_leaves(v))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, v)


def test_reference_pth_loads_strictly_into_syolox_s():
    exp = get_exp("gen1_syolox_s")
    exp.compute_dtype = "float32"
    model = exp.get_model(device="cpu")
    sd = load_reference_state_dict(
        os.path.join(REPO, "checkpoints", "syolox_s_gen1_init.pth"))
    model.load_state_dict(sd, strict=True)
    assert torch.equal(model.backbone.backbone.stem[0].conv.conv.weight,
                       sd["backbone.backbone.stem.0.conv.conv.weight"])
    assert len([k for k in sd if k.endswith(".act.w")]) == 34
    ev = torch.poisson(torch.full((1, 1, 4, 64, 64, 2), 0.2),
                       generator=torch.Generator().manual_seed(0))
    out = model(ev)
    assert out.shape == (1, 84, 7) and torch.isfinite(out).all()


# ------------------------------------------------------- entry points, JAX

def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_exp("gen1_syolox_m").get_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_exp("gen1_syolox_m").get_model(train=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_exp("gen1_syolox_m").get_trainer()
    from eas_snn_tpu_torch.inference import StreamingDetector
    from eas_snn_tpu_torch.models import create_model, load_weights
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingDetector(EASYOLOX(**SMALL), img_size=(48, 64),
                          input_size=(32, 64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("syolox-s-gen1", width=0.125)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_weights(create_model("syolox-s-gen1", device="cpu",
                                  width=0.125), "syolox-s-gen1")


_NO_JAX_RUN = """
import sys
for name in ("jax", "flax", "optax", "orbax", "eas_snn_tpu", "cv2", "PIL"):
    sys.modules[name] = None
import numpy as np
import torch
import eas_snn_tpu_torch.core
import eas_snn_tpu_torch.data
import eas_snn_tpu_torch.tools.train_event
import eas_snn_tpu_torch.utils.logger
import eas_snn_tpu_torch.utils.tracking
from eas_snn_tpu_torch.core import init_ema, train_step
from eas_snn_tpu_torch.data import micro_sum, resize_frames
from eas_snn_tpu_torch.exp import get_exp
exp = get_exp("gen1_syolox_s")
exp.width, exp.depth = 0.125, 0.33
m = exp.get_model(device="cpu")
ev = torch.poisson(torch.full((1, 1, 4, 32, 32, 2), 0.2))
dets = exp.detect(m, ev)
assert len(dets) == 1
m = exp.get_model(device="cpu", train=True)
opt = exp.get_optimizer(m, 1)
lab = torch.zeros(1, 50, 5)
lab[0, 0] = torch.tensor([1.0, 16.0, 16.0, 12.0, 10.0])
out = train_step(m, opt, init_ema(m), ev, lab, to_host=True)
assert all(v == v for v in out.values()) and out["total_loss"] > 0
from eas_snn_tpu_torch.ops.pack import pack_conv_kernel
from eas_snn_tpu_torch.tools.export import export_program, kernel_ops
assert pack_conv_kernel(torch.ones(4, 2, 5, 5), 4).shape == (64, 32, 3, 3)
m = exp.get_model(device="cpu")
assert kernel_ops(export_program(m, ev[:, :, :, :32, :32]))["plif_fwd"] > 0
ev = np.zeros(100, [("t", "<u4"), ("x", "<u2"), ("y", "<u2"), ("p", "u1")])
ev["t"] = np.arange(100)
assert micro_sum(ev, 4, 8, 8).sum() == 96  # t 96-99 past 4 windows of 24
assert resize_frames(np.ones((4, 8, 8, 2), np.float32), (16, 16)).shape \
    == (4, 16, 16, 2)
import eas_snn_tpu_torch.tools.eval_event
import eas_snn_tpu_torch.tools.ap_drift
from eas_snn_tpu_torch.evaluators import DetEval
gt = np.array([[0, 1, 10.0, 10.0, 40.0, 30.0], [1, 0, 5.0, 5.0, 60.0, 50.0]])
det = np.c_[gt, [0.9, 0.8]]
assert DetEval(2).evaluate(det, gt).ap == 1.0
import eas_snn_tpu_torch.tools.psee_evaluate_folders
from eas_snn_tpu_torch.data import (ConcatDataset, Gen4Dataset,
                                    NCaltechDataset, RVTGen4Dataset,
                                    SampleCache, encode_atis,
                                    read_atis_events, voxel_grid)
ev = read_atis_events(encode_atis([5, 9, 70], [1, 2, 3], [4, 240, 6],
                                  [1, 0, 1]))
assert list(ev["t"]) == [5, 70 + 8192]
assert voxel_grid(ev, 8, 8, 2).shape == (2, 8, 8, 1)
assert get_exp("ncaltech_syolox_m").alpha == 1.5
from eas_snn_tpu_torch.data import EVENT_DTYPE
from eas_snn_tpu_torch.inference import StreamingDetector
from eas_snn_tpu_torch.models import create_model, load_weights
from eas_snn_tpu_torch.utils import (MeterBuffer, fuse_conv_bn,
                                     get_model_info, hbm_usage_gb)
import eas_snn_tpu_torch.tools.bench_streaming
m = create_model("syolox-s-gen1", device="cpu", width=0.125)
det = StreamingDetector(m, img_size=(48, 64), input_size=(32, 64), Tm=3,
                        max_events=512, device="cpu")
ev = np.zeros(300, EVENT_DTYPE)
ev["t"] = np.arange(300) * 100
ev["x"], ev["y"], ev["p"] = np.arange(300) % 64, np.arange(300) % 48, 1
det.push(ev)
assert det.outputs().shape == (1, 42, 7)
assert load_weights(create_model("syolox-s-gen1", device="cpu"),
                    "syolox-s-gen1", device="cpu")["mapped"] == 430
assert get_model_info(m, torch.zeros(1, 1, 4, 32, 32, 2)).startswith("Params")
fuse_conv_bn(m)
assert hbm_usage_gb("cpu") == 0.0
import os, tempfile
import eas_snn_tpu_torch.tools.demo
import eas_snn_tpu_torch.tools.play_events
from eas_snn_tpu_torch.utils import vis_detections
from eas_snn_tpu_torch.utils.assign_viz import visualize_assignments
from eas_snn_tpu_torch.utils.png import read_png, write_png
img = vis_detections(np.full((40, 60, 3), 127, np.uint8),
                     np.array([[5.0, 20.0, 40.0, 35.0]]), np.array([0.9]),
                     np.array([1]), class_names=("car", "pedestrian"))
with tempfile.TemporaryDirectory() as d:
    write_png(os.path.join(d, "a.png"), img)
    assert (read_png(os.path.join(d, "a.png")) == img).all()
assert not any(k.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                   "eas_snn_tpu", "cv2", "PIL")
               for k in sys.modules if sys.modules[k] is not None)
print("ok")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", _NO_JAX_RUN], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_no_jax_import_in_port_sources():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax|eas_snn_tpu|cv2|PIL)"
        r"(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "eas_snn_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # kernel build output
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    assert any(f.endswith(os.path.join("core", "trainer.py")) for f in files)
    for new in (("data", "augment.py"), ("data", "loader.py"),
                ("tools", "train_event.py"), ("utils", "tracking.py"),
                ("tools", "eval_event.py"), ("tools", "ap_drift.py"),
                ("evaluators", "__init__.py"), ("evaluators", "coco_map.py"),
                ("evaluators", "voc_eval.py"), ("evaluators", "prophesee.py"),
                ("evaluators", "event_evaluator.py"),
                ("evaluators", "energy.py"),
                ("evaluators", "cocoeval", "__init__.py"),
                ("data", "cache.py"), ("data", "concat.py"),
                ("data", "gen4.py"), ("data", "ncaltech.py"),
                ("tools", "psee_evaluate_folders.py"),
                ("inference", "__init__.py"), ("inference", "streaming.py"),
                ("exp", "base_exp.py"), ("exp", "build.py"),
                ("models", "build.py"), ("utils", "model_info.py"),
                ("utils", "model_surgery.py"), ("utils", "metric.py"),
                ("tools", "bench_streaming.py"), ("parallel", "__init__.py"),
                ("tools", "demo.py"), ("tools", "play_events.py"),
                ("utils", "png.py"), ("utils", "draw.py"),
                ("utils", "visualize.py"), ("utils", "assign_viz.py"),
                ("ops", "library.py"), ("ops", "pack.py"),
                ("tools", "export.py")):
        assert any(f.endswith(os.path.join(*new)) for f in files), new
    hits = [f for f in files if pat.search(open(f).read())]
    assert not hits, hits
    assert not pat.search("import eas_snn_tpu_torch\n"
                          "from eas_snn_tpu_torch.ops import plif\n")
    assert pat.search("    import cv2\n")
    assert pat.search("from PIL import Image\n")
