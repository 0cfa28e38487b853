"""Export of the port's eval forward (``eas_snn_tpu_torch/tools/export.py``)
and the kernel ops it rests on (``eas_snn_tpu_torch/ops/library.py``), on
the CPU: ``torch.library.opcheck`` of every registered op and each op
equal to its plain version bit for bit; the tiny model of
``tests/test_export.py`` (width 0.125, T=2, 64x64, ARSNN ksize 3, depth 1,
Ts 2) built in the port with the JAX weights carried over by
``utils/weights.py:state_dict_from_jax``, exported on the CPU: its graph
names the kernel ops, its state dict holds the parameters, after save and
load it equals the port's eager forward bit for bit, and it equals JAX's
``jax.export`` round trip of the same weights within rtol 1e-5, atol 1e-4
(the tolerance of ``tests/test_torch_model.py::
test_whole_slice_matches_jax_f32``: the spikes agree, the analog sums
differ in order); the launch counts, counted when a kernel runs and not
at trace time; the export CLI on an event preset and an RGB preset.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eas_snn_tpu.models import EASYOLOX as JEASYOLOX

from eas_snn_tpu_torch.models import EASYOLOX
from eas_snn_tpu_torch.ops import arsnn_fused as pf
from eas_snn_tpu_torch.ops import conv_plif as pcp
from eas_snn_tpu_torch.ops import launch_counts, reset_launches
from eas_snn_tpu_torch.ops.library import OPS
from eas_snn_tpu_torch.ops.plif import decay_multiplier, plif_forward_plain
from eas_snn_tpu_torch.tools import export as texport
from eas_snn_tpu_torch.utils import state_dict_from_jax

from test_torch_model import _random_variables
from torch_meta import MetaAsCuda

T = 3
# tests/test_export.py's tiny model
TINY = dict(num_classes=2, depth=0.33, width=0.125, T=2,
            use_spike="backbone", embedding="arsnn", embedding_ksize=3,
            embedding_depth=1, Ts=2, readout="sum", write_zero=True,
            spike_fn="atan", alpha=2.0, thresh=1.0, vreset=None)
EV_SHAPE = (2, 1, 3, 64, 64, 2)
# rtol, atol of the port-vs-JAX forward tests
JAX_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------------ ops

def _op_args(name: str, seed: int = 0):
    """Arguments of ``eas_snn::<name>`` on CPU tensors that make the
    sites fire, and the plain version's result on them."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    w_plif = torch.tensor(0.3)
    if name in ("plif_fwd", "plif_fwd_bn"):
        x = rand(2 * T, 8, 4, 5, scale=1.5)
        bn = (rand(8, scale=0.1), 1.0 + rand(8, scale=0.2), rand(8, scale=0.1))
        a = decay_multiplier(w_plif)
        if name == "plif_fwd":
            return "plif_fwd", (x, T, a, None, None, None, 1.0, True), \
                plif_forward_plain(x, T, w_plif, 1.0, "atan")
        return "plif_fwd", (x, T, a, *bn, 1.0, False), \
            plif_forward_plain(x, T, w_plif, 1.0, "rect", bn=bn)
    if name == "conv1x1_plif":
        xs = [(rand(2 * T, c, 4, 4) > 0.5).to(torch.int8) for c in (8, 16)]
        w, b = rand(16, 24, scale=0.5), rand(16, scale=0.1)
        return name, (xs, w, b, w_plif, T, 1.0, True), \
            pcp.conv1x1_plif_plain(xs, w, b, T, w_plif)
    if name in ("conv3x3_plif", "conv3x3s2_plif"):
        stride = 1 if name == "conv3x3_plif" else 2
        x = rand(2 * T, 8, 5, 6).to(torch.bfloat16)
        w3, b = rand(3, 16, 24, scale=0.4), rand(16, scale=0.1)
        return name, (x, w3, b, w_plif, T, 1.0, True), \
            pcp.conv3x3_plif_plain(x, w3, b, T, w_plif, stride)
    if name == "arsnn_v2":
        ev = rand(3, 2, 2, 8, 8, scale=2.0)
        iw = [(rand(4, 2, 3, 3, scale=0.5), rand(4, scale=0.1)),
              (rand(4, 4, 3, 3, scale=0.5), rand(4, scale=0.1))]
        gw = [(rand(4, 2, 3, 3, scale=0.5), rand(4, scale=0.1)),
              (rand(4, 4, 3, 3, scale=0.5), rand(4, scale=0.1))]
        flat = [p for wb in iw + gw for p in wb]
        kw = dict(Ts=2, thresh=1.0, vreset=None, readout="sum",
                  write_zero=True, use_abs=False)
        return name, (ev, flat, 2, 2, 1.0, None, "sum", True, False), \
            pf.arsnn_fused_v2_plain(ev, iw, gw, **kw)
    assert name == "arsnn_step"
    shape = (2, 2, 4, 4)
    ins = [rand(*shape) for _ in range(4)]
    state = [rand(*shape), rand(*shape),
             torch.randint(0, 2, shape, generator=g, dtype=torch.int8),
             torch.randint(-1, 1, shape, generator=g, dtype=torch.int8),
             rand(3, *shape)]
    want = pf.fused_step_plain(1, *ins, *state, Ts=3, thresh=1.0,
                               vreset=0.0, readout="avg")
    return name, (1, *ins, *[s.clone() for s in state], 3, 1.0, 0.0, "avg",
                  False), want


OP_CASES = ["plif_fwd", "plif_fwd_bn", "conv1x1_plif", "conv3x3_plif",
            "conv3x3s2_plif", "arsnn_v2", "arsnn_step"]


@pytest.mark.parametrize("case", OP_CASES)
def test_opcheck(case):
    """``torch.library.opcheck``: schema (the declared mutations of
    ``arsnn_step`` and none elsewhere), fake tensors, autograd
    registration and AOT dispatch, on CPU tensors."""
    name, args, _ = _op_args(case)
    torch.library.opcheck(OPS[name], args)


@pytest.mark.parametrize("case", OP_CASES)
def test_op_equals_its_plain_version(case):
    """Each op on CPU tensors gives its kernel's plain version's bits
    (``arsnn_step``: the spike returned, the state written in place)."""
    name, args, want = _op_args(case, seed=1)
    got = getattr(torch.ops.eas_snn, name)(*args)
    if name == "arsnn_step":
        vmem, vavg, spike, seg, tlast, agg = want
        assert torch.equal(got, spike)
        for t, w in zip(args[5:10], (vmem, vavg, seg, tlast, agg)):
            assert torch.equal(t, w)
        assert float(spike.sum()) > 0
        return
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert float(got.float().abs().sum()) > 0


def test_wrappers_take_one_route():
    """The wrappers call the op on either device: on the CPU the op's CPU
    implementation runs (the plain version), and no launch is counted."""
    reset_launches()
    x = torch.randn(2 * T, 8, 4, 4)
    out = pcp.conv1x1_plif(x, torch.randn(8, 8), torch.zeros(8), T,
                           torch.tensor(0.0))
    assert out.dtype == torch.int8
    assert all(v == 0 for v in launch_counts().values())


def test_launches_count_at_run_time_not_at_trace(monkeypatch):
    """The device implementation counts its launch (meta tensors stand in
    for CUDA ones, ``tests/torch_meta.py``, the libraries replaced by
    stubs): tracing a program counts nothing, running it counts each
    launch."""
    from eas_snn_tpu_torch.ops import _build

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "get_lib", lambda name: Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)

    class Site(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor(0.3))

        def forward(self, x):
            from eas_snn_tpu_torch.ops import plif_forward

            return plif_forward(x, T, self.w)

    site = Site().to("meta").eval()
    x = torch.empty((2 * T, 16, 8, 8), device="meta")
    reset_launches()
    program = texport.export_program(site, x)
    assert launch_counts()["plif_fwd"] == 0
    assert texport.kernel_ops(program) == {"plif_fwd": 1}
    program.module()(x)
    assert launch_counts()["plif_fwd"] == 0  # the fake: shapes only
    with MetaAsCuda():
        for _ in range(3):
            program.module()(x)
    assert launch_counts()["plif_fwd"] == 3
    reset_launches()


# --------------------------------------------------------- the tiny model

@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny model with firing weights, its ``jax.export`` round
    trip on a Poisson batch, and the events."""
    from jax import export as jexport

    rng = np.random.default_rng(0)
    ev = rng.poisson(0.4, EV_SHAPE).astype(np.float32)
    jm = JEASYOLOX(use_pallas="always", **TINY)
    v = _random_variables(jm, ev, rng)

    def forward(events):
        return jm.apply(v, events)

    exported = jexport.export(jax.jit(forward))(
        jax.ShapeDtypeStruct(ev.shape, jnp.float32))
    reloaded = jexport.deserialize(exported.serialize())
    want = np.asarray(reloaded.call(jnp.asarray(ev)))
    return v, ev, want


@pytest.mark.parametrize("fuse", ["auto", "always"])
def test_tiny_export_round_trip(tiny, tmp_path, fuse):
    """The port's tiny model (``fused_sampler='always'``; ``fuse`` 'auto':
    the policy fuses no site at 64x64, as JAX's, so every spiking site is
    ``plif_fwd``; 'always': every site a conv op) exported on the CPU:
    the graph names the ops, the state dict holds every parameter at its
    value, and the saved and loaded program equals the eager forward bit
    for bit."""
    v, ev, _ = tiny
    pm = EASYOLOX(fuse=fuse, fused_sampler="always", **TINY).eval()
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    x = torch.from_numpy(ev)
    with torch.no_grad():
        want = pm(x)
    program = texport.export_program(pm, x)
    ops = texport.kernel_ops(program)
    expect = ({"plif_fwd", "arsnn_v2"} if fuse == "auto" else
              {"conv1x1_plif", "conv3x3_plif", "conv3x3s2_plif", "arsnn_v2"})
    assert set(ops) == expect and ops["arsnn_v2"] == 1
    path = str(tmp_path / "tiny.pt2")
    torch.export.save(program, path)
    loaded = texport.load_exported(path)
    params = dict(pm.named_parameters())
    assert set(params) <= set(loaded.state_dict)
    for k, p in params.items():
        assert torch.equal(loaded.state_dict[k], p.detach()), k
    assert texport.kernel_ops(loaded) == ops
    with torch.no_grad():
        got = loaded.module()(x)
    assert got.shape == want.shape == (2, 84, 7)
    assert torch.equal(got, want)


def test_tiny_export_matches_jax_export(tiny, tmp_path):
    """The port's exported tiny model against JAX's exported one (JAX
    with ``use_pallas='always'``, the whole-scan sampler kernel, as the
    port's ``fused_sampler='always'``), within rtol 1e-5, atol 1e-4."""
    v, ev, want = tiny
    pm = EASYOLOX(fused_sampler="always", **TINY).eval()
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    x = torch.from_numpy(ev)
    path = str(tmp_path / "tiny.pt2")
    torch.export.save(texport.export_program(pm, x), path)
    with torch.no_grad():
        got = texport.load_exported(path).module()(x).numpy()
    np.testing.assert_allclose(got, want, **JAX_TOL)
    assert (want[..., 4] > 0.05).mean() > 0.05


def test_kept_constants_are_computed_in_the_exported_graph(tiny):
    """Under export the kept eval constants (the PLIF decay multipliers,
    the BN terms) are computed from the weights in the graph, so new
    weights in the program's state dict reach them; eagerly they stay
    kept."""
    v, ev, _ = tiny
    pm = EASYOLOX(fused_sampler="always", **TINY).eval()
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    x = torch.from_numpy(ev)
    with torch.no_grad():
        pm(x)
    site = next(m for m in pm.modules() if hasattr(m, "decay"))
    kept = site._kept_value
    assert kept is not None  # the eager forward kept it
    program = texport.export_program(pm, x)
    text = program.graph_module.code
    assert "sigmoid" in text and "rsqrt" in text
    with torch.no_grad():
        pm(x)
    assert torch.equal(site._kept_value[1], kept[1])


# -------------------------------------------------------------- the CLI

@pytest.mark.parametrize("name,ops", [("gen1_syolox_s", True),
                                      ("yolox_nano", False)])
def test_export_cli(tmp_path, name, ops):
    """``tools/export.py`` on the CPU at a small size: the ``.pt2`` with
    the weights in its state dict, the readable graph, one printed line
    of sizes, and verify on (bit-equal to the eager forward); the event
    preset's graph holds kernel ops, the RGB preset's none."""
    out = str(tmp_path / "m")
    opts = ["test_size", "(64, 64)"] + (["width", "0.125"] if ops else [])
    res = texport.main(["-n", name, "-o", out, "--device", "cpu"] + opts)
    assert os.path.getsize(out + ".pt2") == res["bytes"] > 0
    assert "GraphModule" in open(out + ".txt").read()
    assert res["bit_equal"] and res["max_abs"] == 0.0
    assert bool(res["kernel_ops"]) == ops
    loaded = texport.load_exported(out + ".pt2")
    assert len(loaded.state_dict) == res["weights"] > 100
