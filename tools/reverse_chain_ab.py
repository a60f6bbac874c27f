#!/usr/bin/env python3
"""Time the backward of K7 and K8, which run the reverse cluster kernel
that the encoder-stack backward (K4) runs in windows, for the checkout in
the current directory.

Run from the root of a checkout of the PyTorch port, on one CUDA card:

    python3 <this file> TAG

It imports the port from the current directory, so one command can time
two checkouts in turns (parent, change, change, parent: unpack the other
with ``git archive`` into a directory that ``.gitignore`` lists and run
this file from there). Shapes, seeded random inputs: K7 (``lstm_layer``)
at the Metaformer self-motion LSTM (B32 x T252, 256 -> 256), lws's blocks
(B256 x T140) and simple_lstm's acoustic LSTMs (B256 x T120, 256 -> 128);
K8 (``lstm_recurrence``) at B256 x T120 x H128, B32 x T252 x H256 and
B20 x T37 x H128. Each time is three rounds of 30 launches by CUDA events
after a warm-up, from the forward's residuals. Prints one JSON line with
TAG, ms per launch (one value a round) and, for each shape, a fingerprint
of the backward's output bits (the same in two checkouts whose kernels
do the same arithmetic).
"""

import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())


def rounds_ms(fn, reps=30, rounds=3):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(round(start.elapsed_time(stop) / reps, 4))
    return out


def fingerprint(outs):
    h = hashlib.sha256()
    for o in outs:
        if isinstance(o, torch.Tensor):
            h.update(o.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def main():
    from multimodalreactiongeneration_tpu_torch.ops import (
        lstm_layer as K7,
        lstm_recurrence as K8,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def r(*shape, s=1.0):
        x = (s * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(x).to(dev)

    rec = {"tag": sys.argv[1]}
    for b, t, din, h in ((32, 252, 256, 256), (256, 140, 256, 256),
                         (256, 120, 256, 128)):
        args = (r(b, t, din), r(din, 4 * h, s=0.06), r(4 * h, s=0.06),
                r(h, 4 * h, s=0.06), r(b, h, s=0.3), r(b, h, s=0.3))
        cots = (r(b, t, h), r(b, h), r(b, h))
        out = K7.lstm_layer_forward(args, True)

        def bwd():
            return K7.lstm_layer_backward(args, out[0], out[3], out[4],
                                          *cots)

        rec[f"K7 B{b} T{t} H{h}"] = rounds_ms(bwd)
        rec[f"K7 B{b} T{t} H{h} bits"] = fingerprint(bwd())
    for b, t, h in ((256, 120, 128), (32, 252, 256), (20, 37, 128)):
        args = (r(b, t, 4 * h), r(h, 4 * h, s=0.06), r(b, h, s=0.3),
                r(b, h, s=0.3))
        cots = (r(b, t, h), r(b, h), r(b, h))
        out = K8.lstm_recurrence_forward(args, True)

        def bwd():
            return K8.lstm_recurrence_backward(args, out[0], out[3], out[4],
                                               *cots)

        rec[f"K8 B{b} T{t} H{h}"] = rounds_ms(bwd)
        rec[f"K8 B{b} T{t} H{h} bits"] = fingerprint(bwd())
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
