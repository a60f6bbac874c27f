#!/usr/bin/env python3
"""Time the encoder-stack kernels K1, K3 (forwards) and K4 (backward) of
the checkout in the current directory, over chunk lengths.

Run from the root of a checkout of the PyTorch port, on one CUDA card:

    python3 <this file> TAG [--reps N] [--only K1,K3,K4]

It imports the port from the current directory, so one command can time
two checkouts in turns (parent, change, change, parent: unpack the other
with ``git archive`` into a directory that ``.gitignore`` lists and run
this file from there). Shapes, H256 x L5 with seeded random inputs and
weights: K1 (inference forward) at B16 x T2096 and T262 (the audio and
partner-motion encoders in decode) and B64 x T2096; K3 (training
forward) and K4 (backward, from K3's residuals at its default chunk) at
B32 x T2016 and T252. Where a wrapper takes ``chunk``, each case is
timed at every chunk of the sweep and at chunk = T (the layer-major
schedule), in turns (the sweep, then again in reverse), with the card's
resident clusters; a checkout without ``chunk`` times its one schedule.
Each time is the mean of N launches (default 5) by CUDA events after a
warm-up. The outputs are hashed, so checkouts and chunks can be compared
bit for bit: out, hn, cn, for K3 the residual planes (the first 9L - 1,
which every checkout writes), for K4 dx0, dh0 and dc0. Prints one JSON
line per case and a last one with TAG and the card's name and power
limit.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

SWEEP_LONG = (16, 32, 64, 128)
SWEEP_SHORT = (16, 32, 64)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def digest(tensors, piece=1 << 24):
    """A fingerprint of the tensors' bits, summed on the card in pieces:
    each 32-bit word times a weight of its position, in int64."""
    h = hashlib.sha256()
    for t in tensors:
        flat = t.detach().reshape(-1).view(torch.int32)
        for i in range(0, flat.numel(), piece):
            part = flat[i:i + piece].long()
            w = (torch.arange(i, i + part.numel(), device=part.device)
                 * 2654435761) % 2147483647 + 1
            h.update(str(int((part * w).sum())).encode())
    return h.hexdigest()[:16]


def stack_args(b, t, h=256, n=5, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0, mean=0.0):
        x = mean + s * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.float32)).cuda()

    return (r(b, t, h), r(n, h, 4 * h, s=0.06), r(n, 4 * h, s=0.06),
            r(n, h, 4 * h, s=0.06), r(n, h, h, s=0.06), r(n, h, s=0.1),
            r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
            r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
            r(n, b, h, s=0.3), r(n, b, h, s=0.3))


def run_case(K1, name, b, t, sweep, reps):
    args = stack_args(b, t)
    if name == "K4":
        chunked = hasattr(K1, "backward_chunk_steps")
        res = K1.mixer_stack_train_forward(*args)[3]
        rng = np.random.default_rng(1)
        cots = [torch.from_numpy(rng.standard_normal(tuple(a.shape)).astype(
            np.float32)).cuda() for a in (args[0], args[10], args[11])]

        def call(chunk):
            kw = dict(chunk=chunk) if chunked else {}
            grads = K1.mixer_stack_backward(args, res, *cots, **kw)
            return grads[0], grads[10], grads[11]  # dx0, dh0, dc0
        rule = getattr(K1, "backward_chunk_steps", None)
    else:
        train = name == "K3"
        fn = K1.mixer_stack_train_forward if train else K1.mixer_stack_forward
        chunked = hasattr(K1, "chunk_steps")

        def call(chunk):
            out = fn(*args, chunk=chunk) if chunked else fn(*args)
            if not train:
                return out[0], *out[1]
            # the residual planes every checkout writes (an older one keeps
            # an unwritten plane for the top block's output after them)
            return (*out[:3], out[3][:(9 * 5 - 1) * out[0].numel()])
        rule = getattr(K1, "chunk_steps", None)

    settings = [None]
    if chunked:
        picked = rule(b, t, 256, 5)
        settings = [*sorted({*sweep, picked} - {t}), t]
        settings += settings[::-1]
    rec = {"case": name, "B": b, "T": t, "times": {}}
    if chunked:
        rec["chunk_steps"] = picked
        rec["resident_clusters"] = K1.resident_clusters(256)
    hashes = {}
    with torch.no_grad():
        for chunk in settings:
            key = "default" if chunk is None else f"C{chunk}"
            ms = cuda_ms(lambda: call(chunk), reps)
            rec["times"].setdefault(key, []).append(ms)
            if key not in hashes:
                hashes[key] = digest(call(chunk))
    rec["hashes"] = hashes
    rec["bitwise_equal"] = len(set(hashes.values())) == 1
    print(json.dumps(rec), flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("tag")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="",
                    help="comma-separated kernels to time (K1,K3,K4)")
    a = ap.parse_args()
    from multimodalreactiongeneration_tpu_torch.ops import mixer_stack as K1

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [("K1", 16, 2096, SWEEP_LONG), ("K1", 16, 262, SWEEP_SHORT),
             ("K3", 32, 2016, SWEEP_LONG), ("K3", 32, 252, SWEEP_SHORT),
             ("K4", 32, 2016, (*SWEEP_LONG, 256)),
             ("K4", 32, 252, SWEEP_SHORT),
             ("K1", 64, 2096, (32, 64))]
    if a.only:
        cases = [c for c in cases if c[0] in a.only.split(",")]
    recs = [run_case(K1, n, b, t, sw, a.reps) for n, b, t, sw in cases]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps({"tag": a.tag, "card": card, "cases": len(recs)}))


if __name__ == "__main__":
    main()
