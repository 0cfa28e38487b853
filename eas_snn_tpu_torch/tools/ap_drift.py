"""The AP drift of the port's eval arithmetics on one trained checkpoint
(the port's counterpart of ``tools/ap_drift.py``).

1. writes the JAX tool's synthetic but learnable Gen1 data (two moving
   objects, one a class, emit events inside their boxes over sparse
   background noise; the same draws, through the port's ``psee_io``
   writers), read back by the port's Gen1 pipeline;
2. trains ``gen1_syolox_s`` through the port's ``Trainer`` (the step
   captured as CUDA graphs on the card), evaluating every 20 epochs and
   keeping ``best.pth``;
3. evaluates ``best.pth`` (its EMA weights), each arithmetic in a
   subprocess of its own:
     f32          - f32 conv/BN, f32 sampler state, the plain sampler
                    route, no conv+BN+PLIF fusion;
     deploy       - ``exp.deploy()``: bf16 conv/BN and sampler state, the
                    fused sampler route (on the card: the whole-scan kernel
                    in f32 on the bf16-rounded events), the fusion policy;
     deploy-plain - ``deploy()`` with the plain sampler route (the bf16
                    scan ``deploy()`` runs on a CPU);
4. writes AP and AP50 of each, their deltas against f32, the val AP of
   every evaluation during training and the card into
   ``AP_DRIFT_TORCH.json`` at the root of the repo.

    python -m eas_snn_tpu_torch.tools.ap_drift --geom flagship \\
        [--root DIR] [--epochs 160] [--batch 8] [--skip-train]

``--geom flagship`` is the preset's own geometry (SYOLOX-S at 256x320,
arsnn depth 2 ksize 5, T = Ts = 3, Tm = 4); ``tiny`` is width 0.125,
depth 0.33 at 64x64.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

__all__ = ["make_data", "build_exp", "run_eval", "main"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
H_SENSOR, W_SENSOR = 240, 304
CLASS_SIZES = ((52, 36), (96, 72))  # (w, h) a class: the size is the class
MODES = ("f32", "deploy", "deploy-plain")


# ------------------------------------------------------------------ data

def _make_stream(dat_path, npy_path, seed, duration_us=20_000_000,
                 label_every_us=500_000, events_per_s=60_000):
    """One stream (JAX ``tools/ap_drift.py:53-115``, draw for draw): two
    objects on sinusoidal paths emit dense events inside their boxes, 20%
    of the events are uniform noise; a label group every
    ``label_every_us`` from 300 ms on."""
    from ..data.psee_io import write_bboxes_npy, write_dat_events

    rng = np.random.default_rng(seed)
    n_total = int(events_per_s * duration_us / 1e6)
    phases = rng.uniform(0, 2 * np.pi, (2, 2))
    freqs = rng.uniform(0.05, 0.2, (2, 2))  # Hz

    def centers(ts_us):
        t = ts_us / 1e6
        out = []
        for k, (w, h) in enumerate(CLASS_SIZES):
            mx, my = w / 2 + 4, h / 2 + 4
            cx = (W_SENSOR / 2 + (W_SENSOR / 2 - mx) * np.sin(
                2 * np.pi * freqs[k, 0] * t + phases[k, 0]))
            cy = (H_SENSOR / 2 + (H_SENSOR / 2 - my) * np.sin(
                2 * np.pi * freqs[k, 1] * t + phases[k, 1]))
            out.append((cx, cy))
        return out

    t_ev = np.sort(rng.integers(0, duration_us, n_total)).astype(np.int64)
    src = rng.choice(3, n_total, p=[0.4, 0.4, 0.2])  # obj0 / obj1 / noise
    x = rng.integers(0, W_SENSOR, n_total).astype(np.int64)
    y = rng.integers(0, H_SENSOR, n_total).astype(np.int64)
    cs = centers(t_ev)
    for k, (w, h) in enumerate(CLASS_SIZES):
        m = src == k
        cx, cy = cs[k][0][m], cs[k][1][m]
        x[m] = np.clip((cx + rng.uniform(-w / 2, w / 2, m.sum())).astype(
            np.int64), 0, W_SENSOR - 1)
        y[m] = np.clip((cy + rng.uniform(-h / 2, h / 2, m.sum())).astype(
            np.int64), 0, H_SENSOR - 1)
    p = rng.integers(0, 2, n_total)
    write_dat_events(dat_path, t_ev.astype(np.uint32), x, y, p,
                     H_SENSOR, W_SENSOR)

    rows = []
    # the first label late enough that the -200 ms window has events
    for lt in range(300_000, duration_us, label_every_us):
        c = centers(np.asarray([lt], np.float64))
        for k, (w, h) in enumerate(CLASS_SIZES):
            cx, cy = float(c[k][0][0]), float(c[k][1][0])
            rows.append((lt, cx - w / 2, cy - h / 2, w, h, k, k, 1.0))
    write_bboxes_npy(npy_path, rows)


def make_data(root: str, n_train: int = 6, n_val: int = 3,
              duration_us: int = 20_000_000) -> str:
    """``root``/{train,val} of ``n_train`` and ``n_val`` streams (seeds 0..
    and 100..), each ``duration_us`` long; existing streams are kept."""
    for split, n, base in (("train", n_train, 0), ("val", n_val, 100)):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for s in range(n):
            dat = os.path.join(d, f"drift{s}_td.dat")
            if not os.path.exists(dat):
                _make_stream(dat, os.path.join(d, f"drift{s}_bbox.npy"),
                             seed=base + s, duration_us=duration_us)
    return root


# ------------------------------------------------------------------- exp

def build_exp(root: str, epochs: int, geom: str = "tiny"):
    """``gen1_syolox_s`` with the JAX tool's overrides (``:130-160``)."""
    from ..exp import get_exp

    exp = get_exp("gen1_syolox_s")
    size_opts = [] if geom == "flagship" else [
        "input_size", "(64, 64)", "test_size", "(64, 64)",
        "depth", "0.33", "width", "0.125"]
    exp.merge(size_opts + [
        "data_dir", root, "max_epoch", str(epochs),
        "eval_interval", "20", "print_interval", "10",
        "data_num_workers", "2",
        "output_dir", os.path.join(root, "out"),
        "compute_dtype", "bfloat16",
        # 4x the reference lr an image: the easy synthetic task favours a
        # hotter Adam
        "scheduler", "fixed", "basic_lr_per_img", "6.25e-5",
    ])
    return exp


def run_dir(root: str) -> str:
    return os.path.join(root, "out", "gen1_syolox_s")


def best_ckpt(root: str) -> str:
    return os.path.join(run_dir(root), "ckpt", "best.pth")


def configure(exp, mode: str):
    """``exp`` in the eval arithmetic ``mode`` (one of MODES)."""
    if mode == "f32":
        exp.compute_dtype = "float32"
        exp.embedding_state_dtype = None
        exp.fused_sampler = "never"
        exp.conv_plif_fuse = "never"
    elif mode in ("deploy", "deploy-plain"):
        exp.deploy()
        if mode == "deploy-plain":
            exp.fused_sampler = "never"
    else:
        raise ValueError(f"mode '{mode}' not in {MODES}")
    return exp


def run_eval(root: str, mode: str, batch: int, geom: str, device: str
             ) -> dict:
    """AP and AP50 of ``best.pth`` in the arithmetic ``mode``."""
    from ..core.checkpoint import load_eval_weights

    exp = configure(build_exp(root, epochs=1, geom=geom), mode)
    model = exp.get_model(device=device)
    load_eval_weights(model, best_ckpt(root))
    evaluator = exp.get_evaluator(batch_size=batch)
    ap, ap50, summary = exp.eval(model, evaluator)
    print(summary, file=sys.stderr)
    return {"mode": mode, "ap": float(ap), "ap50": float(ap50),
            "device": device, "compute_dtype": exp.compute_dtype,
            "embedding_state_dtype": exp.embedding_state_dtype,
            "fused_sampler": exp.fused_sampler,
            "conv_plif_fuse": exp.conv_plif_fuse}


def _nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def _curve(root: str) -> list:
    """(step, AP, AP50) of every evaluation during training."""
    path = os.path.join(run_dir(root), "metrics.jsonl")
    rows = [json.loads(r) for r in open(path)] if os.path.exists(path) \
        else []
    return [[r["step"], r["AP50_95"], r["AP50"]] for r in rows
            if r["split"] == "val"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(_REPO, "outputs",
                                                   "ap_drift_torch"))
    ap.add_argument("--epochs", type=int, default=160)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--geom", default="tiny", choices=["tiny", "flagship"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="result file (default: AP_DRIFT_TORCH.json at the "
                         "root of the repo for --geom flagship, else none)")
    ap.add_argument("--phase", default=None, choices=MODES,
                    help="internal: evaluate one arithmetic and print it")
    args = ap.parse_args(argv)

    if args.phase:
        r = run_eval(args.root, args.phase, args.batch, args.geom,
                     args.device)
        print(json.dumps(r))
        return r

    make_data(args.root)
    if not args.skip_train or not os.path.exists(best_ckpt(args.root)):
        exp = build_exp(args.root, args.epochs, geom=args.geom)
        train_args = argparse.Namespace(
            batch_size=args.batch, resume=False, ckpt=None,
            experiment_name=None, grid_search=False, profile=0,
            logger="jsonl")
        exp.get_trainer(train_args, device=args.device).train()

    results = {}
    for mode in MODES:
        r = subprocess.run(
            [sys.executable, "-m", "eas_snn_tpu_torch.tools.ap_drift",
             "--root", args.root, "--batch", str(args.batch), "--geom",
             args.geom, "--device", args.device, "--phase", mode],
            cwd=_REPO, capture_output=True, text=True, timeout=3600)
        sys.stderr.write(r.stderr[-3000:])
        if r.returncode != 0:
            raise SystemExit(f"{mode} failed:\n{r.stdout}\n{r.stderr}")
        results[mode] = json.loads(r.stdout.strip().splitlines()[-1])

    f32 = results["f32"]
    summary = {
        "geom": args.geom, "epochs": args.epochs, "batch": args.batch,
        "card": _nvidia_smi() if args.device == "cuda" else args.device,
        **{m.replace("-", "_"): results[m] for m in MODES},
        "ap_delta": results["deploy"]["ap"] - f32["ap"],
        "ap50_delta": results["deploy"]["ap50"] - f32["ap50"],
        "deploy_plain_ap_delta": results["deploy-plain"]["ap"] - f32["ap"],
        "deploy_plain_ap50_delta":
            results["deploy-plain"]["ap50"] - f32["ap50"],
        "val_curve_step_ap_ap50": _curve(args.root),
    }
    out = args.out or (os.path.join(_REPO, "AP_DRIFT_TORCH.json")
                       if args.geom == "flagship" else None)
    if out:
        with open(out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
