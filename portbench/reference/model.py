"""The plain reference detector: the event embeddings (the ARSNN sampler
and the count embedding), the spiking CSPDarknet, the analog PAFPN and
the decoupled YOLOX head, in plain PyTorch and in NCHW, eval and train.

A frozen restatement of the port's plain code (``eas_snn_tpu_torch/
models/{embedding,blocks,darknet,pafpn,head}.py`` and ``ops/{arsnn,lif,
plif,surrogate}.py``) with every kernel, every mesh path and every option
that no benchmark configuration uses taken out. It imports nothing of the
port. Its parameter and buffer names are the port's, so one state dict
(made by the benchmark) loads into both.

Arithmetic, as the port's plain versions:

* a conv runs in the compute dtype (its input and weight cast to it), a
  BN is ``(x - mean) * rsqrt(var + eps) * weight + bias`` in f32 cast
  back to the compute dtype; in training the statistics are the batch's
  (biased, ``E[x^2] - E[x]^2`` clamped at 0), and the running ones move
  as ``0.97 * running + 0.03 * batch``;
* a PLIF site over T steps folded in the batch (t-major): ``v = v * a +
  x_t`` in f32 with ``a = 1 - sigmoid(w)``, a spike at ``v - 1 >= 0``,
  soft reset; in training the atan surrogate (alpha 2) in the backward,
  which walks back in time as ``ops/plif.py:plif_train_backward_plain``;
* the ARSNN sampler: a gated recurrent LIF over the Tm micro-steps, in
  reversed order, whose spikes (rect surrogate, alpha 1) close the
  current of Ts slots; at eval (the deployed whole-scan route) in f32 on
  the events rounded to bf16, in training with its convs in the compute
  dtype and its state in f32.

``Precision`` names the arithmetic: the configuration's own (bf16 or f32
with TF32 off), or the step below it that a control computes in
(``fp8``: every conv's input and weight rounded to e4m3 with one scale a
tensor; ``tf32``: f32 convs and matmuls in TF32).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

E4M3_MAX = 448.0


class Precision(NamedTuple):
    """``dtype`` the compute dtype of convs; ``quant`` None or 'fp8';
    ``tf32`` whether f32 convs and matmuls may use TF32."""

    dtype: torch.dtype = torch.float32
    quant: Optional[str] = None
    tf32: bool = False


def precision(name: str) -> Precision:
    """'bfloat16', 'float32', 'fp8' (bf16 with fp8 convs) or 'tf32'."""
    return {"bfloat16": Precision(torch.bfloat16),
            "float32": Precision(torch.float32),
            "fp8": Precision(torch.bfloat16, "fp8"),
            "tf32": Precision(torch.float32, None, True)}[name]


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 at one scale (its largest magnitude to 448),
    back in its dtype; the gradient passes straight through."""
    scale = t.detach().abs().amax().float().clamp_min(1e-12) / E4M3_MAX
    q = (t.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q.to(t.dtype) - t).detach()


def conv(x: torch.Tensor, w: torch.Tensor, p: Precision, stride: int = 1,
         padding: int = 0, bias: Optional[torch.Tensor] = None,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A conv in ``dtype`` (default the precision's), the bias added after
    it in that dtype."""
    dt = dtype or p.dtype
    x, w = x.to(dt), w.to(dt)
    if p.quant == "fp8":
        x, w = fake_fp8(x), fake_fp8(w)
    y = F.conv2d(x, w, stride=stride, padding=padding)
    if bias is not None:
        y = y + bias.to(dt)[None, :, None, None]
    return y


# ------------------------------------------------------------ PLIF

def _surrogate_atan(x: torch.Tensor, alpha: float) -> torch.Tensor:
    t = ((math.pi / 2.0) * alpha) * x
    return x.new_full((), alpha / 2.0) / (1.0 + t * t)


def plif_eval(x: torch.Tensor, T: int, a: torch.Tensor,
              thresh: float = 1.0) -> torch.Tensor:
    """Spikes (0/1, in x's dtype) of a (T*B, ...) x; f32 membrane."""
    xs = x.reshape((T, -1) + tuple(x.shape[1:])).float()
    v = torch.zeros_like(xs[0])
    outs = []
    for t in range(T):
        v = v * a + xs[t]
        s = (v - thresh >= 0).float()
        outs.append(s.to(x.dtype))
        v = v - thresh * s
    return torch.stack(outs).reshape(x.shape)


class PLIFTrain(torch.autograd.Function):
    """The train PLIF of ``bn(x)``: forward and backward as the port's
    plain versions (f32 membrane, spikes in x's dtype; atan surrogate)."""

    @staticmethod
    def forward(ctx, x, a, mean, mul, bias, T, thresh, alpha):
        ctx.save_for_backward(x, a, mean, mul, bias)
        ctx.cfg = (T, thresh, alpha)
        shp = (1, -1, 1, 1)
        y = ((x.float() - mean.reshape(shp)) * mul.reshape(shp)
             + bias.reshape(shp)).to(x.dtype)
        return plif_eval(y, T, a.float(), thresh)

    @staticmethod
    def backward(ctx, g):
        x, a, mean, mul, bias = ctx.saved_tensors
        T, thresh, alpha = ctx.cfg
        shp = (1, -1, 1, 1)
        m, s, b = (p.float().reshape(shp) for p in (mean, mul, bias))
        af = a.float()
        xs = x.reshape((T, -1) + tuple(x.shape[1:]))
        gs = g.reshape(xs.shape)
        v = torch.zeros(xs.shape[1:], dtype=torch.float32, device=x.device)
        xms, d_pre, v_prev = [], [], []
        for t in range(T):
            v_prev.append(v)
            xm = xs[t].float() - m
            xms.append(xm)
            v = v * af + (xm * s + b).to(x.dtype).float()
            d = v - thresh
            d_pre.append(d)
            v = v - thresh * (d >= 0).float()
        dx = torch.empty_like(xs)
        da = torch.zeros(1, dtype=torch.float32, device=x.device)
        ds = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
        db = torch.zeros_like(ds)
        g_after = torch.zeros_like(v)
        for t in range(T - 1, -1, -1):
            fp = _surrogate_atan(d_pre[t], alpha)
            g_pre = g_after + (gs[t].float() - thresh * g_after) * fp
            dx[t] = (g_pre * s).to(x.dtype)
            ds += (g_pre * xms[t]).sum((0, 2, 3))
            db += g_pre.sum((0, 2, 3))
            da += (g_pre * v_prev[t]).sum()
            g_after = g_pre * af
        dm = -(mul.float() * db)
        return (dx.reshape(x.shape), da.reshape(a.shape).to(a.dtype), dm, ds,
                db, None, None, None)


# ------------------------------------------------------------ blocks

class BatchNorm(nn.BatchNorm2d):
    """eps 1e-3; the terms (mean, mul, bias) of ``(x - mean) * mul +
    bias``: the running statistics' at eval, the batch's in training."""

    def __init__(self, n: int):
        super().__init__(n, eps=1e-3, momentum=0.03)

    def terms(self, x: torch.Tensor):
        if not self.training:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return self.running_mean.float(), mul.float(), self.bias.float()
        xf = x.float()
        mean = xf.mean((0, 2, 3))
        var = torch.clamp_min((xf * xf).mean((0, 2, 3)) - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.copy_(0.97 * self.running_mean + 0.03 * mean)
            self.running_var.copy_(0.97 * self.running_var + 0.03 * var)
            self.num_batches_tracked += 1
        return mean, torch.rsqrt(var + self.eps) * self.weight, self.bias


def bn_apply(x, mean, mul, bias, dtype):
    shp = (1, -1, 1, 1)
    return ((x.float() - mean.reshape(shp)) * mul.reshape(shp)
            + bias.reshape(shp)).to(dtype)


class PLIF(nn.Module):
    def __init__(self, T: int):
        super().__init__()
        self.T = T
        self.w = nn.Parameter(torch.tensor(0.0))


class Ctx(NamedTuple):
    """What every block needs: the precision and the spiking T (0:
    analog)."""

    p: Precision
    T: int


class BaseConv(nn.Module):
    """conv -> BN -> SiLU, or conv -> BN -> PLIF at a spiking site (the
    conv then at ``conv.0``, the decay logit at ``act.w``)."""

    def __init__(self, cin, cout, k, stride, c: Ctx):
        super().__init__()
        self.k, self.stride, self.c = k, stride, c
        cv = nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=False)
        self.spiking = c.T > 0
        self.conv = nn.Sequential(cv) if self.spiking else cv
        self.bn = BatchNorm(cout)
        if self.spiking:
            self.act = PLIF(c.T)

    @property
    def weight(self):
        return self.conv[0].weight if self.spiking else self.conv.weight

    def forward(self, x):
        if isinstance(x, (tuple, list)):
            x = torch.cat([t.to(self.c.p.dtype) for t in x], 1)
        y = conv(x, self.weight, self.c.p, self.stride, (self.k - 1) // 2)
        terms = self.bn.terms(y)
        if not self.spiking:
            return F.silu(bn_apply(y, *terms, self.c.p.dtype))
        if self.training:
            a = 1.0 - torch.sigmoid(self.act.w.float())
            return PLIFTrain.apply(y, a, *terms, self.c.T, 1.0, 2.0)
        a = 1.0 - torch.sigmoid(self.act.w.detach().float())
        return plif_eval(bn_apply(y, *terms, y.dtype), self.c.T, a)


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, shortcut, expansion, c: Ctx):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = BaseConv(cin, hidden, 1, 1, c)
        self.conv2 = BaseConv(hidden, cout, 3, 1, c)
        self.use_add = shortcut and cin == cout

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class CSPLayer(nn.Module):
    def __init__(self, cin, cout, n, shortcut, c: Ctx):
        super().__init__()
        hidden = int(cout * 0.5)
        self.conv1 = BaseConv(cin, hidden, 1, 1, c)
        self.conv2 = BaseConv(cin, hidden, 1, 1, c)
        self.conv3 = BaseConv(2 * hidden, cout, 1, 1, c)
        self.m = nn.Sequential(*[Bottleneck(hidden, hidden, shortcut, 1.0, c)
                                 for _ in range(n)])

    def forward(self, x):
        return self.conv3((self.m(self.conv1(x)), self.conv2(x)))


def _pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Stride-1 same-padded k x k max pool, rows then columns."""
    x = F.max_pool2d(x, (k, 1), stride=1, padding=(k // 2, 0))
    return F.max_pool2d(x, (1, k), stride=1, padding=(0, k // 2))


class SPPBottleneck(nn.Module):
    def __init__(self, cin, cout, c: Ctx):
        super().__init__()
        hidden = cin // 2
        self.conv1 = BaseConv(cin, hidden, 1, 1, c)
        self.conv2 = BaseConv(hidden * 4, cout, 1, 1, c)

    def forward(self, x):
        x = self.conv1(x)
        p5 = _pool(x.float(), 5)
        p9 = _pool(p5, 5)
        p13 = _pool(p9, 5)
        return self.conv2((x, p5.to(x.dtype), p9.to(x.dtype),
                           p13.to(x.dtype)))


class Focus(nn.Module):
    def __init__(self, cin, cout, c: Ctx):
        super().__init__()
        self.conv = BaseConv(4 * cin, cout, 3, 1, c)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]],
                                   1))


class CSPDarknet(nn.Module):
    def __init__(self, dep, wid, cin, c: Ctx, analog: Ctx):
        super().__init__()
        base, d = int(wid * 64), max(round(dep * 3), 1)
        self.stem = nn.Sequential(Focus(cin, base, analog))
        self.dark2 = nn.Sequential(BaseConv(base, base * 2, 3, 2, c),
                                   CSPLayer(base * 2, base * 2, d, True, c))
        self.dark3 = nn.Sequential(BaseConv(base * 2, base * 4, 3, 2, c),
                                   CSPLayer(base * 4, base * 4, d * 3, True, c))
        self.dark4 = nn.Sequential(BaseConv(base * 4, base * 8, 3, 2, c),
                                   CSPLayer(base * 8, base * 8, d * 3, True, c))
        self.dark5 = nn.Sequential(BaseConv(base * 8, base * 16, 3, 2, c),
                                   SPPBottleneck(base * 16, base * 16, c),
                                   CSPLayer(base * 16, base * 16, d, False, c))

    def forward(self, x):
        x = self.stem(x)
        x = self.dark2(x)
        f3 = self.dark3(x)
        f4 = self.dark4(f3)
        f5 = self.dark5(f4)
        return f3, f4, f5


def up2(x):
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class YOLOPAFPN(nn.Module):
    def __init__(self, dep, wid, cin, backbone: Ctx, neck: Ctx):
        super().__init__()
        self.T = backbone.T
        self.backbone = CSPDarknet(dep, wid, cin, backbone, neck)
        c0, c1, c2 = (int(ch * wid) for ch in (256, 512, 1024))
        n = round(3 * dep)
        self.lateral_conv0 = BaseConv(c2, c1, 1, 1, neck)
        self.C3_p4 = CSPLayer(2 * c1, c1, n, False, neck)
        self.reduce_conv1 = BaseConv(c1, c0, 1, 1, neck)
        self.C3_p3 = CSPLayer(2 * c0, c0, n, False, neck)
        self.bu_conv2 = BaseConv(c0, c0, 3, 2, neck)
        self.C3_n3 = CSPLayer(2 * c0, c1, n, False, neck)
        self.bu_conv1 = BaseConv(c1, c1, 3, 2, neck)
        self.C3_n4 = CSPLayer(2 * c1, c2, n, False, neck)

    def forward(self, x):
        feats = self.backbone(x)
        if self.T:  # rate-decode the spike trains, f32
            feats = [f.reshape((self.T, -1) + tuple(f.shape[1:])).float()
                     .mean(0) for f in feats]
        x2, x1, x0 = feats
        fpn_out0 = self.lateral_conv0(x0)
        f_out0 = self.C3_p4((up2(fpn_out0), x1))
        fpn_out1 = self.reduce_conv1(f_out0)
        pan_out2 = self.C3_p3((up2(fpn_out1), x2))
        pan_out1 = self.C3_n3((self.bu_conv2(pan_out2), fpn_out1))
        pan_out0 = self.C3_n4((self.bu_conv1(pan_out1), fpn_out0))
        return pan_out2, pan_out1, pan_out0


class YOLOXHead(nn.Module):
    STRIDES = (8, 16, 32)

    def __init__(self, num_classes, wid, c: Ctx):
        super().__init__()
        self.num_classes, self.c = num_classes, c
        hidden = int(256 * wid)

        def tower():
            return nn.Sequential(BaseConv(hidden, hidden, 3, 1, c),
                                 BaseConv(hidden, hidden, 3, 1, c))

        chans = [int(ch * wid) for ch in (256, 512, 1024)]
        self.stems = nn.ModuleList(BaseConv(ch, hidden, 1, 1, c)
                                   for ch in chans)
        self.cls_convs = nn.ModuleList(tower() for _ in chans)
        self.reg_convs = nn.ModuleList(tower() for _ in chans)
        self.cls_preds = nn.ModuleList(nn.Conv2d(hidden, num_classes, 1)
                                       for _ in chans)
        self.reg_preds = nn.ModuleList(nn.Conv2d(hidden, 4, 1)
                                       for _ in chans)
        self.obj_preds = nn.ModuleList(nn.Conv2d(hidden, 1, 1)
                                       for _ in chans)

    def _pred(self, m: nn.Conv2d, x):
        return conv(x, m.weight, self.c.p, bias=m.bias).float()

    def forward(self, xin):
        outs, origins, gxs, gys, svs = [], [], [], [], []
        for k, (stride, x) in enumerate(zip(self.STRIDES, xin)):
            x = self.stems[k](x)
            cls_out = self._pred(self.cls_preds[k], self.cls_convs[k](x))
            reg_feat = self.reg_convs[k](x)
            reg_out = self._pred(self.reg_preds[k], reg_feat)
            obj_out = self._pred(self.obj_preds[k], reg_feat)
            out = torch.cat([reg_out, obj_out, cls_out], 1)
            B, _, H, W = out.shape
            out = out.reshape(B, out.shape[1], H * W).permute(0, 2, 1)
            yv, xv = torch.meshgrid(
                torch.arange(H, dtype=torch.float32, device=out.device),
                torch.arange(W, dtype=torch.float32, device=out.device),
                indexing="ij")
            gx, gy = xv.reshape(-1), yv.reshape(-1)
            if self.training:
                xy = (out[..., :2] + torch.stack([gx, gy], -1)[None]) * stride
                wh = torch.exp(out[..., 2:4]) * stride
                outs.append(torch.cat([xy, wh, out[..., 4:]], -1))
                origins.append(out[..., :4])
            else:
                outs.append(torch.cat([out[..., :4],
                                       torch.sigmoid(out[..., 4:])], -1))
            gxs.append(gx)
            gys.append(gy)
            svs.append(torch.full((H * W,), float(stride),
                                  device=out.device))
        out = torch.cat(outs, 1)
        gx, gy, sv = torch.cat(gxs), torch.cat(gys), torch.cat(svs)
        if self.training:
            return out, torch.cat(origins, 1), gx, gy, sv
        xy = (out[..., :2] + torch.stack([gx, gy], -1)[None]) \
            * sv[None, :, None]
        wh = torch.exp(out[..., 2:4]) * sv[None, :, None]
        return torch.cat([xy, wh, out[..., 4:]], -1)


# ------------------------------------------------------------ embeddings

def fold_time(events: torch.Tensor) -> torch.Tensor:
    """(B, Tl, Tm, H, W, C) -> time-reversed (Tm, B*Tl, C, H, W)."""
    B, Tl, Tm = events.shape[:3]
    ev = events.reshape((B * Tl,) + tuple(events.shape[2:]))
    return ev.movedim(1, 0).flip(0).permute(0, 1, 4, 2, 3)


class CountEmbedding(nn.Module):
    """The micro-frames summed: (B*Tl, C, H, W)."""

    def forward(self, events):
        return fold_time(events).sum(0)


def _rect_spike(x: torch.Tensor) -> torch.Tensor:
    """Hard spike at x > 0 with the rect surrogate (alpha 1) as gradient."""
    hard = (x > 0).to(x.dtype)
    surr = (x.abs() < 0.5).to(x.dtype)
    return hard + (x * surr - (x * surr).detach())


class ARSNNEmbedding(nn.Module):
    """The adaptive sampler, readout 'sum', ``write_zero``, soft reset,
    threshold 1, Ts slots; ``input_conv`` and ``gate_conv`` are
    ``conv [ReLU conv]*`` stacks (convs at 0, 2, ...)."""

    def __init__(self, ksize: int, depth: int, Ts: int, p: Precision):
        super().__init__()
        self.Ts, self.p, self.k = Ts, p, ksize

        def stack(cin):
            layers = []
            for i in range(depth):
                if i:
                    layers.append(nn.ReLU())
                layers.append(nn.Conv2d(cin if i == 0 else 4, 4, ksize,
                                        padding=ksize // 2))
            return nn.Sequential(*layers)

        self.input_conv = stack(2)
        self.gate_conv = stack(2)

    def _stack(self, stack, x, dt):
        out = x.dtype
        for m in stack:
            x = torch.relu(x) if isinstance(m, nn.ReLU) else conv(
                x, m.weight, self.p, padding=self.k // 2, bias=m.bias,
                dtype=dt)
        return x.to(out)

    def forward(self, events):
        ev = fold_time(events)
        in_dtype = ev.dtype
        if self.training:   # convs in the compute dtype, f32 state
            dt = self.p.dtype
            ev = ev.float()
        else:               # the deployed route: f32 on bf16-rounded events
            dt = torch.float32
            ev = ev.to(torch.bfloat16).float()
        Tm, N = ev.shape[:2]
        inp = self._stack(self.input_conv, ev.reshape((Tm * N,)
                                                      + tuple(ev.shape[2:])),
                          dt)
        inp = inp.reshape((Tm, N) + tuple(inp.shape[1:]))
        g_all, c_all = inp[:, :, :2], inp[:, :, 2:]
        shape = g_all.shape[1:]
        zero = torch.zeros(shape, dtype=torch.float32, device=ev.device)
        vmem = spike = vavg = zero
        seg = torch.zeros(shape, dtype=torch.int64, device=ev.device)
        agg = torch.zeros((self.Ts,) + tuple(shape), dtype=torch.float32,
                          device=ev.device)
        iota = torch.arange(self.Ts, device=ev.device).reshape(
            (self.Ts,) + (1,) * len(shape))
        for t in range(Tm):
            state = self._stack(self.gate_conv, spike, dt)
            gate = torch.sigmoid(g_all[t] + state[:, :2])
            v = gate * vmem + (c_all[t] + state[:, 2:])
            spike = _rect_spike(v - 1.0)
            vmem = v - 1.0 * spike
            vavg = vavg + v
            spiked = spike.detach() > 0.5
            valid = spiked & (seg < self.Ts)
            write = torch.where(valid, vavg, torch.zeros_like(vavg))
            agg = agg + (seg[None] == iota).float() * write[None]
            seg = seg + valid.long()
            vavg = torch.where(spiked, torch.zeros_like(vavg), vavg)
        # write_zero: the residual write of an unclosed slot writes 0
        return agg.to(in_dtype)


# ------------------------------------------------------------ detector

class Detector(nn.Module):
    """The configuration's detector: ``embedding`` 'arsnn' (spiking
    backbone, analog neck and head) or 'count' (all analog)."""

    def __init__(self, cfg: dict, p: Precision):
        super().__init__()
        m = cfg["model"]
        self.T = m["T"] if m["use_spike"] else 0
        analog = Ctx(p, 0)
        spiking = Ctx(p, self.T)
        if m["embedding"] == "arsnn":
            self.embedding = ARSNNEmbedding(m["embedding_ksize"],
                                            m["embedding_depth"], m["Ts"], p)
        else:
            self.embedding = CountEmbedding()
        self.backbone = YOLOPAFPN(m["depth"], m["width"], 2,
                                  spiking if self.T else analog, analog)
        self.head = YOLOXHead(m["num_classes"], m["width"], analog)
        self.num_classes = m["num_classes"]

    def forward(self, events):
        x = self.embedding(events)
        if self.T:
            if x.dim() == 4:
                x = x[None].expand((self.T,) + tuple(x.shape))
            x = x.reshape((-1,) + tuple(x.shape[2:]))
        elif x.dim() == 5:
            x = x[0]
        return self.head(self.backbone(x))


def spiking_sites(model: nn.Module):
    """The spiking BaseConvs of ``model``, in forward order."""
    return [m for m in model.modules()
            if isinstance(m, BaseConv) and m.spiking]
