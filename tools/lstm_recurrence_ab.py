#!/usr/bin/env python3
"""Time the LSTM recurrence kernels over precomputed inputs (K8,
``csrc/lstm_recurrence.cu``) of the checkout in the current directory,
and split a chain step into its phases.

Run from the root of a checkout of the PyTorch port, on one CUDA card:

    python3 <this file> TAG [--stamps] [--ctas C] [--batch N]

It imports the port from the current directory, so one command can time
two checkouts in turns (parent, change, change, parent: unpack the other
with ``git archive`` into a directory that ``.gitignore`` lists and run
this file from there). Shapes, seeded random inputs: K8's four shapes of
``chip_smoke.py`` phase 18: B256 x T120 x H128 (a simple_lstm acoustic
direction), B32 x T252 x H256 (the flagship's self-motion LSTMs under
``MRGEN_FUSED_DW=0``), B20 x T37 x H128 (ragged) and B1 x T120 x H128 (a
frame of the ``MRGEN_FUSED_DW=0`` simple_lstm rollout). Times are
CUDA-event means of three rounds of ``REPS`` launches after a warm-up:
the forward without residuals, with residuals, and the backward from
them. For each shape, a fingerprint of the output bits (the same in two
checkouts whose kernels do the same arithmetic), the largest forward
difference from the plain version and the largest gradient difference
relative to the largest plain gradient.

Where the checkout chooses a cluster size per launch, the JSON also gets
the clusters of 16 rows the card holds at once per H and cluster size
(``resident``) and the size chosen for each shape (``cluster_ctas``).
``--ctas C`` runs every launch at a hidden size that takes clusters of
C CTAs over clusters of C, whatever the wrapper would choose (the others
at the wrapper's choice), by replacing the module's ``launch_ctas``.
``--batch N`` adds BN x T120 x H128 and BN x T252 x H256.
``--stamps`` also runs one forward with residuals and one backward at
B256 x T120 x H128 and B32 x T252 x H256 from a build with
``-DLSTM_STAMPS``: thread 0 of each of the first 16 CTAs stamps
``%globaltimer`` at five marks of each of 16 steps, and the JSON gets,
per phase, the median over those steps of the mean over the CTAs, in
microseconds. Forward phases: the product (to the ``__syncthreads``
after the K split), the cell, the exchange stores, the wait (with the
stores of ys and the residuals and the next step's xw loads before it);
backward: the cell, the carry product, the exchange stores, the wait
(with the next step's input loads before it). ``step_us`` is the
median time from a step's start to the next step's start. Prints one
JSON line with TAG and the card's name and power limit.
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

REPS = 20
SHAPES = ((256, 120, 128), (32, 252, 256), (20, 37, 128), (1, 120, 128))
STAMP_SHAPES = ((256, 120, 128), (32, 252, 256))
FWD_PHASES = ("product", "cell", "stores", "wait")
BWD_PHASES = ("cell", "product", "stores", "wait")


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
def stamped():
    """Inside, the K8 wrappers launch ``lstm_recurrence.cu`` built with
    -DLSTM_STAMPS; yields that build."""
    from multimodalreactiongeneration_tpu_torch import _build

    load = _build.load
    _build.load = lambda name, d=(): load(name, ("LSTM_STAMPS", *d))
    try:
        yield _build.load("lstm_recurrence")
    finally:
        _build.load = load


def inputs(r, b, t, h):
    args = (r(b, t, 4 * h, s=0.5), r(h, 4 * h, s=0.06), r(b, h, s=0.3),
            r(b, h, s=0.3))
    return args, (r(b, t, h), r(b, h), r(b, h))


def time_shape(K8, r, b, t, h):
    args, cots = inputs(r, b, t, h)
    fwd = lambda res: K8.lstm_recurrence_forward(args, res)
    rec = {"fwd_ms": rounds_ms(lambda: fwd(False)),
           "fwd_res_ms": rounds_ms(lambda: fwd(True))}
    ys, hn, cn, acts, cs = fwd(True)
    rec["bwd_ms"] = rounds_ms(lambda: K8.lstm_recurrence_backward(
        args, ys, acts, cs, *cots))
    grads = K8.lstm_recurrence_backward(args, ys, acts, cs, *cots)
    with torch.no_grad():
        want = K8.lstm_recurrence_reference(*args)
    rec["fwd_max_abs_err"] = max(float((a - w).abs().max()) for a, w in
                                 zip((ys, hn, cn), (want[0], *want[1])))
    rec["grad_max_rel_err"] = max_rel(
        grads, K8.lstm_recurrence_backward_reference(args, *cots))
    rec["us_per_step"] = {k: round(min(v) * 1e3 / t, 3)
                          for k, v in rec.items() if k.endswith("_ms")}
    rec["bits"] = fingerprint([ys, hn, cn, acts, cs, *grads])
    return rec


def stamp_split(K8, lib, r, b, t, h):
    """Per phase of a forward and a backward step, microseconds."""
    lib.lstm_recurrence_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.lstm_recurrence_stamps.restype = ctypes.c_int
    dims = (ctypes.c_int * 4)()
    if lib.lstm_recurrence_stamps(None, dims):
        raise RuntimeError("lstm_recurrence_stamps: reset failed")
    t0, steps, ctas, marks = list(dims)
    args, cots = inputs(r, b, t, h)
    ys, _, _, acts, cs = K8.lstm_recurrence_forward(args, True)
    K8.lstm_recurrence_backward(args, ys, acts, cs, *cots)
    buf = np.zeros((2, steps, ctas, marks), dtype=np.uint64)
    if lib.lstm_recurrence_stamps(buf.ctypes.data, dims):
        raise RuntimeError("lstm_recurrence_stamps: read failed")
    out = {"stamped_steps": [t0, t0 + steps]}
    for d, (name, phases) in enumerate((("fwd", FWD_PHASES),
                                        ("bwd", BWD_PHASES))):
        s = buf[d].astype(np.int64)
        s = s[:, s[0, :, 0] > 0]  # the stamped CTAs
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
    from multimodalreactiongeneration_tpu_torch.ops import (
        lstm_recurrence as K8,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def r(*shape, s=1.0):
        x = (s * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(x).to(dev)

    shapes = SHAPES + tuple(
        s for i, a in enumerate(argv) if a == "--batch"
        for s in ((int(argv[i + 1]), 120, 128), (int(argv[i + 1]), 252, 256)))
    record = {"tag": tag}
    if "--ctas" in argv:
        forced, chosen = int(argv[argv.index("--ctas") + 1]), K8.launch_ctas
        K8.launch_ctas = lambda d, b, h, *mode: (
            forced if forced in K8.CLUSTER_CTAS[h] else chosen(d, b, h,
                                                               *mode))
        record["forced_ctas"] = forced
    for b, t, h in shapes:
        record[f"B{b} T{t} H{h}"] = time_shape(K8, r, b, t, h)
    if hasattr(K8, "launch_ctas"):
        record["resident"] = {
            h: {c: K8._lib().lstm_recurrence_resident_clusters(h, c)
                for c in ctas} for h, ctas in K8.CLUSTER_CTAS.items()}
        record["cluster_ctas"] = {f"B{b} H{h}": K8.launch_ctas(dev, b, h)
                                  for b, _, h in shapes}
    if "--stamps" in argv:
        with stamped() as lib:
            record["stamps"] = {f"B{b} T{t} H{h}": stamp_split(
                K8, lib, r, b, t, h) for b, t, h in STAMP_SHAPES}
    record["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
