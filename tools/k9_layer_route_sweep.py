#!/usr/bin/env python3
"""Time K9's layer route (``ops/lstm_stacked.py``, the stacks the
wavefront cannot hold, ``csrc/lstm_recurrence.cu lstm_stacked_layers_*``)
over window lengths C, on one CUDA card.

Run from the root of a checkout of the PyTorch port:

    python3 tools/k9_layer_route_sweep.py

Shapes, seeded random inputs: the Metaformer's 2-inner-layer LSTM mixers
at H256 (B32 x T2016 and T252 in training, B16 x T2096 the decode hoist),
the same at 3 layers, the bf16 mode at B32 x T2016, and H128 x L4 at B256
x T1120 (past the wavefront's 3 layers). Per C in {16, 32, 64, 128, 256,
T} (C = T runs the layers one after the other), CUDA-event means of three
launches after a warm-up: the forward without residuals, with residuals,
and the backward from them. One JSON line a shape, then the card's name
and power limit.
"""

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
from multimodalreactiongeneration_tpu_torch.ops import (  # noqa: E402
    lstm_stacked as K9,
)

SHAPES = [  # (B, T, H, L, bf16)
    (32, 2016, 256, 2, False), (32, 252, 256, 2, False),
    (16, 2096, 256, 2, False), (32, 2016, 256, 3, False),
    (32, 2016, 256, 2, True), (256, 1120, 128, 4, False),
]


def cuda_ms(fn, reps=3):
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for b, t, h, layers, bf16 in SHAPES:
        gen = torch.Generator().manual_seed(0)

        def r(*shape, s=1.0):
            return (s * torch.randn(*shape, generator=gen)).to(dev)

        w = (lambda a: a.to(torch.bfloat16)) if bf16 else (lambda a: a)
        args = (r(b, t, 4 * h), w(r(layers - 1, h, 4 * h, s=0.06)),
                r(layers - 1, 4 * h, s=0.06), w(r(layers, h, 4 * h, s=0.06)),
                r(layers, b, h, s=0.3), r(layers, b, h, s=0.3))
        cots = (r(b, t, h), r(layers, b, h), r(layers, b, h))
        by_chunk = {}
        for c in sorted({16, 32, 64, 128, 256, t} & set(range(1, t + 1))):
            fwd = cuda_ms(lambda: K9.lstm_stacked_forward(args, False,
                                                          chunk=c))[0]
            fwd_res, out = cuda_ms(lambda: K9.lstm_stacked_forward(
                args, True, chunk=c))
            bwd = cuda_ms(lambda: K9.lstm_stacked_backward(
                args[1:], out[0], *out[3:], *cots, chunk=c))[0]
            by_chunk[c] = dict(fwd_ms=fwd, fwd_res_ms=fwd_res, bwd_ms=bwd)
            del out
        print(json.dumps(dict(B=b, T=t, H=h, L=layers, bf16=bf16,
                              chosen=K9.layers_chunk(t), ms=by_chunk)),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
