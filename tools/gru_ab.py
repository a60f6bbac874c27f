#!/usr/bin/env python3
"""Time the GRU recurrence kernels (K10, ``csrc/gru.cu``) of the checkout
in the current directory, and split a chain step into its phases.

Run from the root of a checkout of the PyTorch port, on one CUDA card:

    python3 <this file> TAG [--stamps] [--batch N] [--ctas C]

It imports the port from the current directory, so one command can time
two checkouts in turns (parent, change, change, parent: unpack the other
with ``git archive`` into a directory that ``.gitignore`` lists and run
this file from there). Shapes, seeded random inputs: K10's four shapes
of ``chip_smoke.py`` phase 14: H256 at B32 x T2016 (an audio-encoder
block in training), B32 x T252 (a motion block), B16 x T2096 (the decode
hoist, forward only), and H128 at B32 x T252. Times are CUDA-event means
of three rounds of ``REPS`` launches after a warm-up: the forward
without residuals, with residuals, and the backward from them. For each
shape, a fingerprint of the output bits (the same in two checkouts whose
kernels do the same arithmetic) and the largest difference from the
plain version.

``--batch N`` adds H256 at BN x T2016 (the GRU yaml's own batch is 128),
and the JSON gets, where the checkout chooses a cluster size per launch,
the clusters of 16 rows the card holds at once per H and cluster size
(``resident``) and the size chosen for each shape (``cluster_ctas``).
``--ctas C`` runs every H256 launch over clusters of C CTAs (8 or 16),
whatever the wrapper would choose. ``--stamps`` also runs one
forward with residuals and one backward at H256 B32 x T2016 and at H128
B32 x T252 from a build with ``-DGRU_STAMPS`` (a checkout whose source
has the stamps): thread 0 of each of the first 16 CTAs stamps
``%globaltimer`` at five marks of each of 16 steps, and the JSON gets,
per phase, the median over those steps of the mean over the CTAs, in
microseconds. Forward phases: the product, the cell (with its stores),
the exchange stores, the barrier; backward: the cell (to the
``__syncthreads`` after it), the carry product, the exchange stores,
the barrier. ``step_us`` is the median time from a step's start to the
next step's start. Prints one JSON line with TAG and the card's name and
power limit.
"""

import contextlib
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

REPS = 10
SHAPES = ((32, 2016, 256, True), (32, 252, 256, True),
          (16, 2096, 256, False), (32, 252, 128, True))
STAMP_SHAPES = ((32, 2016, 256), (32, 252, 128))
FWD_PHASES = ("product", "cell", "stores", "barrier")
BWD_PHASES = ("cell", "product", "stores", "barrier")


def rounds_ms(fn, rounds=3):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(round(start.elapsed_time(stop) / REPS, 4))
    return out


def fingerprint(outs):
    h = hashlib.sha256()
    for o in outs:
        h.update(o.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def max_rel(got, want):
    return max(float((g - w).abs().max()) / float(w.abs().max())
               for g, w in zip(got, want))


@contextlib.contextmanager
def stamped(K10):
    """Inside, K10's wrappers launch ``gru.cu`` built with -DGRU_STAMPS."""
    from multimodalreactiongeneration_tpu_torch import _build

    load = _build.load
    _build.load = lambda name, d=(): load(name, ("GRU_STAMPS", *d))
    try:
        yield _build.load("gru")
    finally:
        _build.load = load


def inputs(r, b, t, h):
    args = (r(b, t, 3 * h, s=0.5), r(h, 3 * h, s=0.06), r(3 * h, s=0.1),
            r(b, h, s=0.3))
    return args, (r(b, t, h), r(b, h))


def time_shape(K10, r, b, t, h, backward):
    args, cots = inputs(r, b, t, h)
    rec = {"fwd_ms": rounds_ms(lambda: K10.gru_forward(args, False))}
    ys, hn, _ = K10.gru_forward(args, False)
    with torch.no_grad():
        want = K10.gru_recurrence_reference(*args)
    rec["fwd_max_abs_err"] = max(float((a - w).abs().max())
                                 for a, w in zip((ys, hn), want))
    outs = [ys, hn]
    if backward:
        rec["fwd_res_ms"] = rounds_ms(lambda: K10.gru_forward(args, True))
        ys, hn, hh = K10.gru_forward(args, True)
        rec["bwd_ms"] = rounds_ms(
            lambda: K10.gru_backward(args, ys, hh, *cots))
        grads = K10.gru_backward(args, ys, hh, *cots)
        rec["grad_max_rel_err"] = max_rel(
            grads, K10.gru_backward_reference(args, *cots))
        outs += [hh, *grads]
    rec["bits"] = fingerprint(outs)
    return rec


def stamp_split(K10, lib, r, b, t, h):
    """Per phase of a forward and a backward step, microseconds."""
    lib.gru_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.gru_stamps.restype = ctypes.c_int
    dims = (ctypes.c_int * 4)()
    if lib.gru_stamps(None, dims):
        raise RuntimeError("gru_stamps: reset failed")
    t0, steps, ctas, marks = list(dims)
    args, cots = inputs(r, b, t, h)
    ys, hn, hh = K10.gru_forward(args, True)
    K10.gru_backward(args, ys, hh, *cots)
    buf = np.zeros((2, steps, ctas, marks), dtype=np.uint64)
    if lib.gru_stamps(buf.ctypes.data, dims):
        raise RuntimeError("gru_stamps: read failed")
    out = {"stamped_steps": [t0, t0 + steps]}
    for d, (name, phases) in enumerate((("fwd", FWD_PHASES),
                                        ("bwd", BWD_PHASES))):
        s = buf[d].astype(np.int64)
        s = s[:, s[0, :, 0] > 0]  # the cluster's CTAs
        spans = np.diff(s, axis=2) / 1000.0  # (steps, ctas, phases) us
        rec = {p: float(np.median(spans[:, :, i].mean(axis=1)))
               for i, p in enumerate(phases)}
        rec["step_us"] = float(np.median(np.diff(s[:, :, 0], axis=0)) / 1000)
        rec["ctas"] = int(s.shape[1])
        out[name] = rec
    return out


def main():
    argv = sys.argv[1:]
    tag = argv[0] if argv and not argv[0].startswith("--") else os.getcwd()
    shapes = SHAPES + tuple((int(argv[i + 1]), 2016, 256, True)
                            for i, a in enumerate(argv) if a == "--batch")
    from multimodalreactiongeneration_tpu_torch.ops import gru as K10

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def r(*shape, s=1.0):
        x = (s * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(x).to(dev)

    record = {"tag": tag}
    if "--ctas" in argv:
        forced, chosen = int(argv[argv.index("--ctas") + 1]), K10.launch_ctas
        K10.launch_ctas = lambda d, b, h, *mode: (
            forced if h == 256 else chosen(d, b, h, *mode))
        record["forced_ctas_h256"] = forced
    for b, t, h, backward in shapes:
        record[f"B{b} T{t} H{h}"] = time_shape(K10, r, b, t, h, backward)
    if hasattr(K10, "launch_ctas"):
        record["resident"] = {
            h: {c: K10._lib().gru_resident_clusters(h, c) for c in ctas}
            for h, ctas in K10.CLUSTER_CTAS.items()}
        record["cluster_ctas"] = {f"B{b} H{h}": K10.launch_ctas(dev, b, h)
                                  for b, _, h, _ in shapes}
    if "--stamps" in argv:
        with stamped(K10) as lib:
            record["stamps"] = {f"B{b} T{t} H{h}": stamp_split(
                K10, lib, r, b, t, h) for b, t, h in STAMP_SHAPES}
    record["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
