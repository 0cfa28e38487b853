"""The frozen arithmetic of the yardstick: every conv of a configuration's
detector from its shapes alone (no model is built), the model FLOPs of a
forward and of a train step, and the least time the H100 could take for
the work of the hand kernels' rows, against its published peaks at 700 W.

Frozen copies: ``bound_ms``, ``v2_bound``, ``PLIF_OPS``, ``BN_OPS``,
``BWD_OPS``, ``SAMPLER_OPS`` and ``HBM_BYTES_PER_S`` of ``chip_smoke.py``
(the bound column of ``PERF.md`` section 6), and the table of fused
sites of ``eas_snn_tpu_torch/ops/conv_plif_policy.py`` (which sites of
the flagship's eval forward the whole-site kernels serve). The bounds
count each input byte read once and each output byte written once; where
the bytes and the operations differ, the larger time is the bound.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12      # dense bf16 tensor-core peak
F32_FLOPS = 67e12           # f32 outside the tensor cores (TF32 off)
PEAK_FLOPS = {"bfloat16": BF16_TC_FLOPS, "float32": F32_FLOPS}
PLIF_OPS = 6                # f32 operations an element and step
BN_OPS = 3                  # the BN folded into the PLIF kernel
BWD_OPS = 24                # f32 operations an element of the backward
SAMPLER_OPS = 20            # f32 operations an element and micro-step

# (ksize, stride, H_in, W_in, n_pieces, cin_total, cout) of the sites the
# whole-site conv + BN + PLIF kernels serve at eval (the policy table)
FUSED_SITES = {
    (1, 1, 64, 80, 1, 96, 48),
    (1, 1, 64, 80, 2, 96, 96),
    (3, 1, 32, 40, 1, 96, 96),
    (1, 1, 32, 40, 2, 192, 192),
    (1, 1, 16, 20, 1, 384, 192),
    (1, 1, 16, 20, 2, 384, 384),
    (1, 1, 8, 10, 2, 768, 768),
    (3, 2, 128, 160, 1, 48, 96),
}


class Conv(NamedTuple):
    """One conv: ``pieces`` the channel counts of its input's concat
    pieces, (H, W) its input's size, ``steps`` how many times a sample it
    runs (T for the spiking backbone, Tm for the sampler, else 1),
    ``spiking`` whether a PLIF site follows it, ``spike_in`` whether its
    input is a spike train."""

    name: str
    pieces: Tuple[int, ...]
    cout: int
    k: int
    stride: int
    H: int
    W: int
    steps: int
    spiking: bool
    spike_in: bool

    @property
    def cin(self) -> int:
        return sum(self.pieces)

    @property
    def out_hw(self) -> Tuple[int, int]:
        return ((self.H - 1) // self.stride + 1,
                (self.W - 1) // self.stride + 1)

    def macs(self) -> int:
        """Multiply-adds a sample."""
        ho, wo = self.out_hw
        return self.steps * ho * wo * self.cout * self.cin * self.k ** 2

    def out_elems(self) -> int:
        """Output elements a sample."""
        ho, wo = self.out_hw
        return self.steps * self.cout * ho * wo


def convs(model: dict) -> List[Conv]:
    """Every conv of the configuration's detector, in forward order."""
    H, W = model["input_size"]
    spk = bool(model["use_spike"])
    T = model["T"] if spk else 1
    dep, wid = model["depth"], model["width"]
    out: List[Conv] = []

    def add(name, pieces, cout, k, s, h, w, steps=1, spiking=False,
            spike_in=False):
        out.append(Conv(name, tuple(pieces), cout, k, s, h, w, steps,
                        spiking, spike_in))

    if model["embedding"] == "arsnn":
        k, depth, Tm = (model["embedding_ksize"], model["embedding_depth"],
                        model["Tm"])
        for stack in ("input_conv", "gate_conv"):
            for i in range(depth):
                add(f"embedding.{stack}.{2 * i}", (2 if i == 0 else 4,), 4,
                    k, 1, H, W, steps=Tm * model["Tl"])

    def csp(name, cin_pieces, cout, n, h, w, steps, spiking, spike_in,
            shortcut=True):
        hid = int(cout * 0.5)
        add(f"{name}.conv1", cin_pieces, hid, 1, 1, h, w, steps, spiking,
            spike_in)
        add(f"{name}.conv2", cin_pieces, hid, 1, 1, h, w, steps, spiking,
            spike_in)
        for j in range(n):
            add(f"{name}.m.{j}.conv1", (hid,), hid, 1, 1, h, w, steps,
                spiking, spiking)
            add(f"{name}.m.{j}.conv2", (hid,), hid, 3, 1, h, w, steps,
                spiking, spiking)
        add(f"{name}.conv3", (hid, hid), cout, 1, 1, h, w, steps, spiking,
            spiking)

    base, d = int(wid * 64), max(round(dep * 3), 1)
    bb = "backbone.backbone"
    h, w = H // 2, W // 2
    add(f"{bb}.stem.0.conv", (8,), base, 3, 1, h, w, T)
    chans = (base, base * 2, base * 4, base * 8, base * 16)
    for i, n in ((2, d), (3, 3 * d), (4, 3 * d)):
        cin, cout = chans[i - 2], chans[i - 1]
        add(f"{bb}.dark{i}.0", (cin,), cout, 3, 2, h, w, T, spk,
            spk and i > 2)
        h, w = h // 2, w // 2
        csp(f"{bb}.dark{i}.1", (cout,), cout, n, h, w, T, spk, spk)
    add(f"{bb}.dark5.0", (chans[3],), chans[4], 3, 2, h, w, T, spk, spk)
    h, w = h // 2, w // 2
    c5 = chans[4]
    add(f"{bb}.dark5.1.conv1", (c5,), c5 // 2, 1, 1, h, w, T, spk, spk)
    add(f"{bb}.dark5.1.conv2", (c5 // 2,) * 4, c5, 1, 1, h, w, T, spk, spk)
    csp(f"{bb}.dark5.2", (c5,), c5, d, h, w, T, spk, spk, shortcut=False)

    c0, c1, c2 = (int(ch * wid) for ch in (256, 512, 1024))
    n = round(3 * dep)
    s8, s16, s32 = ((H // s, W // s) for s in (8, 16, 32))
    add("backbone.lateral_conv0", (c2,), c1, 1, 1, *s32)
    csp("backbone.C3_p4", (c1, c1), c1, n, *s16, 1, False, False)
    add("backbone.reduce_conv1", (c1,), c0, 1, 1, *s16)
    csp("backbone.C3_p3", (c0, c0), c0, n, *s8, 1, False, False)
    add("backbone.bu_conv2", (c0,), c0, 3, 2, *s8)
    csp("backbone.C3_n3", (c0, c0), c1, n, *s16, 1, False, False)
    add("backbone.bu_conv1", (c1,), c1, 3, 2, *s16)
    csp("backbone.C3_n4", (c1, c1), c2, n, *s32, 1, False, False)

    hid = int(256 * wid)
    for lvl, (ch, hw) in enumerate(zip((c0, c1, c2), (s8, s16, s32))):
        add(f"head.stems.{lvl}", (ch,), hid, 1, 1, *hw)
        for tower in ("cls_convs", "reg_convs"):
            for j in range(2):
                add(f"head.{tower}.{lvl}.{j}", (hid,), hid, 3, 1, *hw)
        for pred, c in (("cls_preds", model["num_classes"]),
                        ("reg_preds", 4), ("obj_preds", 1)):
            add(f"head.{pred}.{lvl}", (hid,), c, 1, 1, *hw)
    return out


def forward_flops(model: dict, batch: int) -> Dict[str, float]:
    """Model FLOPs of one forward of ``batch`` samples (2 a multiply-add),
    by the dtype they run in: the sampler's in ``sampler_dtype``, the
    rest in ``dtype``."""
    out: Dict[str, float] = {}
    for c in convs(model):
        dt = model["sampler_dtype"] if c.name.startswith("embedding") \
            else model["dtype"]
        out[dt] = out.get(dt, 0.0) + 2.0 * c.macs() * batch
    return out


def train_flops(model: dict, batch: int) -> Dict[str, float]:
    """A train step: the forward once, the backward twice (the input's
    and the weights' gradients), nothing recomputed; the sampler's convs
    in the train route's dtype (``dtype``)."""
    out: Dict[str, float] = {}
    for c in convs(model):
        out[model["dtype"]] = out.get(model["dtype"], 0.0) \
            + 3 * 2.0 * c.macs() * batch
    return out


def peak_seconds(flops: Dict[str, float]) -> float:
    """The least time the flops take at the published peaks."""
    return sum(v / PEAK_FLOPS[k] for k, v in flops.items())


def bound_ms(nbytes: float, tc_flops: float, f32_ops: float):
    """(bound in ms, 'bytes' or 'operations') for one call."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = tc_flops / BF16_TC_FLOPS + f32_ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def v2_bound(Tm: int, N: int, H: int, W: int, Ts: int, depth: int, k: int,
             nw: int, ev_bytes: int = 2) -> float:
    """The whole-scan sampler kernel's bound (ms) over (Tm, N, 2, H, W)
    events: the events read and the slots written once, the stencils'
    multiply-adds as FMAs (the gate stack not at t = 0, where it sees no
    spikes), SAMPLER_OPS a state element and step, in f32."""
    px = N * H * W
    inner = (depth - 1) * 16
    macs = px * k * k * (Tm * (2 * 4 + inner) + (Tm - 1) * (2 * 4 + inner))
    nbytes = Tm * N * 2 * H * W * ev_bytes + Ts * N * 2 * H * W * 4 + 4 * nw
    return bound_ms(nbytes, 0.0, 2 * macs + SAMPLER_OPS * 2 * px * Tm)[0]


def sites(model: dict) -> List[Conv]:
    return [c for c in convs(model) if c.spiking]


def plif_train_bound_ms(model: dict, batch: int) -> float:
    """Rows 7 and 8 of a train step: the BN-fused PLIF forward and its
    backward at every spiking site, bf16 storage."""
    es, total = 2, 0.0
    for c in sites(model):
        n, C = c.out_elems() * batch, c.cout
        total += bound_ms(2 * n * es + 12 * C + 4, 0.0,
                          (PLIF_OPS + BN_OPS) * n)[0]
        total += bound_ms(3 * n * es + 12 * C + 4 + 16 * C, 0.0,
                          (PLIF_OPS + BN_OPS + BWD_OPS) * n)[0]
    return total


def fused(c: Conv) -> bool:
    return (c.k, c.stride, c.H, c.W, len(c.pieces), c.cin,
            c.cout) in FUSED_SITES


def eval_sites_bound_ms(model: dict, batch: int) -> Dict[str, float]:
    """Rows 1-5 of one eval forward, by kernel: the PLIF kernel at the
    unfused sites (bf16 in, int8 spikes out, the BN folded in), the
    whole-site conv kernels at the fused ones (the inputs read once, int8
    spikes or the bf16 stem output; bf16 folded weights; int8 out) and
    the whole-scan sampler kernel."""
    out = {"plif_fwd_kernel": 0.0, "conv_wgmma_kernel": 0.0,
           "arsnn_v2_kernel": 0.0}
    for c in sites(model):
        n_out = c.out_elems() * batch
        if fused(c):
            es = 1 if c.spike_in else 2
            ho, wo = c.out_hw
            nin = c.steps * batch * c.cin * c.H * c.W * es
            nbytes = nin + c.cout * c.cin * c.k ** 2 * 2 + c.cout * 4 + 4 \
                + n_out
            out["conv_wgmma_kernel"] += bound_ms(
                nbytes, 2.0 * n_out * c.cin * c.k ** 2,
                PLIF_OPS * n_out)[0]
        else:
            out["plif_fwd_kernel"] += bound_ms(
                n_out * 3 + 12 * c.cout + 4, 0.0,
                (PLIF_OPS + BN_OPS) * n_out)[0]
    if model["embedding"] == "arsnn":
        H, W = model["input_size"]
        k, depth = model["embedding_ksize"], model["embedding_depth"]
        nw = 2 * (2 * 4 * k * k + 4 + (depth - 1) * (16 * k * k + 4))
        out["arsnn_v2_kernel"] = v2_bound(
            model["Tm"], batch * model["Tl"], H, W, model["Ts"], depth, k, nw)
    return out
