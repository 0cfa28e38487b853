"""The port's front doors against the JAX package's, on the CPU in f32:
exp files and names (``exp/build.py``, both CLIs' ``-f``), the
experiment base class, the model zoo (``models/build.py``: every
``MODEL_SPECS`` entry's forward on the same weights, the zoo checkpoint),
the model report (``utils/model_info.py``), conv+BN folding and freeze
labels (``utils/model_surgery.py``) and the meters (``utils/metric.py``).
Tiny widths (0.125, depth 0.33) at 64x64."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eas_snn_tpu.models import MODEL_SPECS as JMODEL_SPECS
from eas_snn_tpu.models import create_model as jcreate_model
from eas_snn_tpu.utils import AverageMeter as JAverageMeter
from eas_snn_tpu.utils import MeterBuffer as JMeterBuffer
from eas_snn_tpu.utils import count_params as jcount_params
from eas_snn_tpu.utils import freeze_labels as jfreeze_labels
from eas_snn_tpu.utils import fuse_conv_bn as jfuse_conv_bn
from eas_snn_tpu.utils import get_model_info as jget_model_info

from eas_snn_tpu_torch.exp import (BaseExp, EventExp, get_exp,
                                   get_exp_by_file, get_exp_by_name)
from eas_snn_tpu_torch.models import (MODEL_SPECS, ZOO_CKPTS, EASYOLOX,
                                      create_model, load_weights)
from eas_snn_tpu_torch.tools import eval_event, train_event
from eas_snn_tpu_torch.utils import (AverageMeter, MeterBuffer,
                                     count_params, freeze, freeze_labels,
                                     fuse_conv_bn, get_model_info,
                                     hbm_usage_gb, state_dict_from_jax)

from test_torch_model import _random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(width=0.125, depth=0.33)
EV_SHAPE = (2, 1, 4, 64, 64, 2)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# --------------------------------------------------------------- exp files

_USER_EXP = '''
from eas_snn_tpu_torch.exp import EventExp


class Exp(EventExp):
    def __init__(self):
        super().__init__()
        self.exp_name = "my_gen1"
        self.num_classes = 2
        self.data_name = "gen1"
        self.width, self.depth = 0.125, 0.33
        self.input_size = self.test_size = (64, 96)
        self.max_epoch = 7
'''


def test_exp_file_loads_through_both_clis(tmp_path):
    """``-f`` loads a user file whose ``Exp`` subclasses the port's
    ``EventExp``; the CLIs' overrides and flags apply to it as to a
    preset."""
    path = tmp_path / "my_exp.py"
    path.write_text(_USER_EXP)
    exp = get_exp_by_file(str(path))
    assert isinstance(exp, EventExp) and isinstance(exp, BaseExp)
    assert (exp.exp_name, exp.max_epoch) == ("my_gen1", 7)
    assert type(get_exp(str(path))).__name__ == "Exp"
    texp, targs = train_event.build(["-f", str(path), "--device", "cpu",
                                     "max_epoch", "3"])
    assert (texp.exp_name, texp.max_epoch, targs.device) == ("my_gen1", 3,
                                                             "cpu")
    eexp, _ = eval_event.build(["-f", str(path), "--fp16", "-b", "2"])
    assert eexp.exp_name == "my_gen1" and eexp.fused_sampler == "auto"
    assert eexp.compute_dtype == "bfloat16"  # deploy()
    m = eexp.get_model(device="cpu")
    assert m.head.num_classes == 2

    jax_file = tmp_path / "jax_exp.py"
    jax_file.write_text("from eas_snn_tpu.exp import EventExp\n\n"
                        "class Exp(EventExp):\n    pass\n")
    for build in (train_event.build, eval_event.build):
        with pytest.raises(SystemExit, match="JAX package"):
            build(["-f", str(jax_file)])
    other = tmp_path / "other_exp.py"
    other.write_text("class Exp:\n    pass\n")
    with pytest.raises(SystemExit, match="subclass"):
        train_event.build(["-f", str(other)])
    with pytest.raises(SystemExit, match="no exp file"):
        eval_event.build(["-f", str(tmp_path / "missing.py")])


def test_exp_by_name_and_an_unknown_name():
    """Names resolve through the port's presets ('-' and '_' alike); an
    unknown name raises KeyError with the presets, and the CLIs refuse it
    with that list; ``get_exp(name)`` keeps naming a preset."""
    assert get_exp_by_name("gen1-syolox-m").exp_name == "gen1_syolox_m"
    assert get_exp("e_yolox_s").exp_name == "e_yolox_s"
    assert get_exp(exp_name="gen1_syolox_s").width == 0.5
    with pytest.raises(KeyError, match="gen1_syolox_m"):
        get_exp_by_name("no_such_exp")
    for build in (train_event.build, eval_event.build):
        with pytest.raises(SystemExit, match="gen1_syolox_m"):
            build(["-n", "no_such_exp"])
        with pytest.raises(SystemExit, match="-f or -n"):
            build([])
    with pytest.raises(ValueError, match="exp file or an exp name"):
        get_exp()


def test_base_exp_repr_and_contract():
    """``EventExp`` is a ``BaseExp``: its repr lists its fields, a
    ``BaseExp`` without the factories cannot be made, and ``merge``
    coerces as before."""
    exp = get_exp("gen1_syolox_m")
    text = repr(exp)
    assert "'exp_name': 'gen1_syolox_m'" in text and "'Tm': 4" in text
    with pytest.raises(TypeError):
        BaseExp()
    exp.merge(["Tm", "3", "seed", "5", "data_dir", "/data/x"])
    assert (exp.Tm, exp.seed, exp.data_dir) == (3, 5, "/data/x")


# -------------------------------------------------------------- model zoo

def test_model_specs_equal_the_jax_zoo():
    assert MODEL_SPECS == JMODEL_SPECS
    assert ZOO_CKPTS == {"syolox-s-gen1": "checkpoints/syolox_s_gen1_init.pth"}
    with pytest.raises(KeyError, match="syolox-m-gen1"):
        create_model("no-such-model", device="cpu")


@pytest.mark.parametrize("name", sorted(JMODEL_SPECS))
def test_create_model_forward_matches_jax(name):
    """Each zoo entry at a tiny width ('_' and '-' alike): the port's
    ``create_model`` loads the JAX ``create_model``'s variables (numpy
    draws with firing BN statistics) strictly by name, and its eval
    forward equals JAX's within the slice tolerance (rtol 1e-5, atol
    1e-4)."""
    rng = np.random.default_rng(1)
    ev = rng.poisson(0.2, EV_SHAPE).astype(np.float32)
    jm = jcreate_model(name.replace("-", "_"), **TINY)
    v = _random_variables(jm, ev, rng)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(ev)))
    pm = create_model(name, device="cpu", **TINY)
    assert not pm.training
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(ev)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_load_weights_of_the_zoo_checkpoint_and_a_port_checkpoint(tmp_path):
    """``load_weights('syolox-s-gen1')`` maps all 430 tensors of the
    in-repo checkpoint, leaving none of the model's and none of the
    file's; a port checkpoint loads its EMA weights."""
    m = create_model("syolox-s-gen1", device="cpu", seed=3)
    rep = load_weights(m, "syolox_s_gen1", device="cpu")
    assert rep == {"mapped": 430, "kept_current": 0, "total": 430,
                   "unmapped": 0}
    ref = torch.load(os.path.join(REPO, ZOO_CKPTS["syolox-s-gen1"]),
                     map_location="cpu", weights_only=True)
    ref = ref.get("model", ref)
    sd = m.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in ref.items())

    small = create_model("syolox-s-gen1", device="cpu", **TINY)
    ema = {n: p.detach() + 1.0 for n, p in small.named_parameters()}
    ckpt = tmp_path / "best.pth"
    torch.save({"model": small.state_dict(), "optimizer": {}, "ema": ema,
                "step": 3, "best_ap": 0.0}, ckpt)
    other = create_model("syolox-s-gen1", device="cpu", seed=9, **TINY)
    rep = load_weights(other, str(ckpt), device="cpu")
    assert rep["mapped"] == rep["total"] and rep["unmapped"] == 0
    for n, p in other.named_parameters():
        assert torch.equal(p, ema[n]), n
    # a model of another width keeps what does not fit
    rep = load_weights(create_model("syolox-s-gen1", device="cpu",
                                    width=0.25, depth=0.33), str(ckpt),
                       device="cpu")
    assert rep["unmapped"] > 0 and rep["kept_current"] > 0


# ------------------------------------------------------------- model info

@pytest.mark.parametrize("spec", [
    dict(use_spike="none", embedding="count", num_classes=80),
    dict(use_spike="backbone", embedding="arsnn", embedding_depth=2,
         embedding_ksize=5, Ts=3, T=3, num_classes=2)])
def test_model_info_equals_jax(spec):
    """Parameters and the 'Params: N.NNM, Gflops: X.XX' line of the same
    model (MACs a frame from the conv accounting) equal JAX's."""
    from eas_snn_tpu.models import EASYOLOX as JEASYOLOX

    kw = dict(spec, **TINY)
    sample = np.zeros((1, 1, 4, 64, 64, 2), np.float32)
    jm = JEASYOLOX(**kw)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(sample))
    pm = EASYOLOX(**kw)
    assert count_params(pm) == jcount_params(v["params"])
    want = jget_model_info(jm, v, jnp.asarray(sample))
    got = get_model_info(pm, torch.from_numpy(sample))
    assert got == want and got.startswith("Params: ")


# ---------------------------------------------------------- model surgery

def test_fuse_conv_bn_matches_jax():
    """JAX ``tests/test_core.py``'s case: the analog model with non-trivial
    BN statistics keeps its eval output within rtol 2e-3, atol 2e-4 when
    each conv / BN pair is folded, and the folded weights and BN terms
    equal the JAX package's fold within 1e-6."""
    from eas_snn_tpu.models import EASYOLOX as JEASYOLOX

    kw = dict(num_classes=2, depth=0.33, width=0.125, use_spike="none",
              embedding="count")
    rng = np.random.default_rng(3)
    ev = rng.normal(size=(1, 1, 1, 64, 64, 2)).astype(np.float32)
    jm = JEASYOLOX(**kw)
    v = jax.tree_util.tree_map(np.asarray, dict(jm.init(
        jax.random.PRNGKey(0), jnp.asarray(ev))))
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda x: x + 0.3 * rng.standard_normal(x.shape).astype(x.dtype)
        ** 2, v["batch_stats"])
    pm = EASYOLOX(**kw).eval()
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        ref = pm(torch.from_numpy(ev)).numpy()
    folded = fuse_conv_bn(pm, inplace=False)
    with torch.no_grad():
        assert np.array_equal(pm(torch.from_numpy(ev)).numpy(), ref)
        out = folded(torch.from_numpy(ev)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-4)
    want = state_dict_from_jax(jfuse_conv_bn(v))
    got = folded.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert fuse_conv_bn(pm) is pm


def test_freeze_labels_equal_jax_by_name():
    """The label of each parameter equals the JAX package's label of the
    same parameter (names through the weights bridge), for prefixes at
    the top and inside the tree; ``freeze`` turns the frozen ones'
    ``requires_grad`` off."""
    from eas_snn_tpu.models import EASYOLOX as JEASYOLOX

    kw = dict(num_classes=2, depth=0.33, width=0.125,
              use_spike="backbone", embedding="arsnn", T=2, Ts=2,
              embedding_ksize=3)
    jm = JEASYOLOX(**kw)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1, 2, 32, 32, 2)))["params"]
    pm = EASYOLOX(**kw)
    for prefixes in (["backbone"], ["embedding", "head"], ["dark2", "dark3"],
                     ["stem"]):
        jl = jfreeze_labels(params, prefixes)
        # labels as leaves of a tree the bridge names: 1.0 frozen
        tree = jax.tree_util.tree_map(
            lambda lab, p: np.full(p.shape, lab == "frozen", np.float32),
            jl, params)
        want = {k: bool(t.flatten()[0]) for k, t in
                state_dict_from_jax({"params": tree}).items()}
        got = freeze_labels(pm, prefixes)
        assert set(got) == set(want)
        assert {k: v == "frozen" for k, v in got.items()} == want, prefixes
        assert 0 < sum(want.values()) < len(want)
    n = freeze(pm, ["backbone"])
    assert n == sum(not p.requires_grad for p in pm.parameters()) > 0


# ----------------------------------------------------------------- meters

def test_meters_equal_jax():
    seq = [3.0, 1.5, 4.25, 0.5, 9.0, 2.0, 6.5]
    jm, pm = JAverageMeter(window_size=4), AverageMeter(window_size=4)
    for x in seq:
        jm.update(x)
        pm.update(x)
        for k in ("median", "avg", "global_avg", "latest"):
            assert getattr(pm, k) == getattr(jm, k), k
    pm.clear()
    jm.clear()
    assert (pm.avg, pm.global_avg) == (jm.avg, jm.global_avg)
    pm.reset()
    jm.reset()
    assert (pm.global_avg, pm.latest, pm.count) == (jm.global_avg,
                                                   jm.latest, 0)
    jb, pb = JMeterBuffer(3), MeterBuffer(3)
    for i, x in enumerate(seq):
        jb.update({"loss_iou": x}, loss_obj=2 * x, lr=0.1 * i)
        pb.update({"loss_iou": x}, loss_obj=2 * x, lr=0.1 * i)
    assert set(pb.get_filtered_meter("loss")) == set(
        jb.get_filtered_meter("loss")) == {"loss_iou", "loss_obj"}
    pb.clear_meters()
    jb.clear_meters()
    assert pb["lr"].global_avg == jb["lr"].global_avg
    pb.reset()
    assert pb["lr"].count == 0
    assert hbm_usage_gb("cpu") == 0.0
