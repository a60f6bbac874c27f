#!/usr/bin/env python3
"""Time the LSTM chains K7 and K9 of the checkout in the current directory.

Run from the root of a checkout of the PyTorch port, on one CUDA card:

    python3 <this file> TAG

It imports the port from the current directory, so one command can time
two checkouts in turns (parent, change, change, parent: unpack the other
with ``git archive`` into a directory that ``.gitignore`` lists and run
this file from there). Shapes: K9 at lstm_with_sampling's sampler in
training, B256 x T1120 x H128 x L2; K7 at its blocks, B256 x T140,
256 -> 256, and at simple_lstm's acoustic LSTMs, B256 x T120, 256 -> 128.
Each time is the mean of 10 launches by CUDA events after a warm-up:
forward without residuals, with residuals, backward. Where the wrappers
take ``rows``, every rows per cluster of ``cluster_rows.ROWS`` the kernel
takes is timed; where K7 has its tensor-core product, it is timed beside
``torch.addmm`` at the forward's input product. Prints one JSON line with
TAG and the card's name and power limit.
"""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

REPS = 10


def cuda_ms(fn):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS


def rand(rng, dev):
    def r(*shape, s=1.0):
        return torch.from_numpy(
            (s * rng.standard_normal(shape)).astype(np.float32)).to(dev)
    return r


def time_chain(fwd, bwd, rows):
    """fwd(residuals, **kw) -> outputs; bwd(outputs, **kw) -> grads."""
    kw = {} if rows is None else {"rows": rows}
    out = fwd(True, **kw)
    return {"fwd_ms": cuda_ms(lambda: fwd(False, **kw)),
            "fwd_res_ms": cuda_ms(lambda: fwd(True, **kw)),
            "bwd_ms": cuda_ms(lambda: bwd(out, **kw))}


def main():
    from multimodalreactiongeneration_tpu_torch.ops import (
        lstm_layer as K7,
        lstm_stacked as K9,
    )

    tag = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    r = rand(rng, dev)
    takes_rows = "rows" in inspect.signature(K9.lstm_stacked_forward).parameters
    record = {"tag": tag}

    b, t, h, layers = 256, 1120, 128, 2
    args = (r(b, t, 4 * h), r(layers - 1, h, 4 * h, s=0.06),
            r(layers - 1, 4 * h, s=0.06), r(layers, h, 4 * h, s=0.06),
            r(layers, b, h, s=0.3), r(layers, b, h, s=0.3))
    cots = (r(b, t, h), r(layers, b, h), r(layers, b, h))
    k9 = {}
    for rows in (16, 24, 32) if takes_rows else (None,):
        if rows is not None and rows not in K9.layout(0, layers, False)[0]:
            continue
        k9[str(rows)] = time_chain(
            lambda res, **kw: K9.lstm_stacked_forward(args, res, **kw),
            lambda o, **kw: K9.lstm_stacked_backward(
                args[1:], o[0], o[3], o[4], o[5], *cots, **kw), rows)
    record["k9_b256_t1120"] = k9
    del args, cots

    for name, (b, t, din, h) in (("k7_b256_t140", (256, 140, 256, 256)),
                                 ("k7_b256_t120_h128", (256, 120, 256, 128))):
        args = (r(b, t, din), r(din, 4 * h, s=0.06), r(4 * h, s=0.06),
                r(h, 4 * h, s=0.06), r(b, h, s=0.3), r(b, h, s=0.3))
        cots = (r(b, t, h), r(b, h), r(b, h))
        k7 = {}
        for rows in (16, 24, 32) if takes_rows else (None,):
            if rows is not None and rows not in K7.layout(0, h, False)[0]:
                continue
            k7[str(rows)] = time_chain(
                lambda res, **kw: K7.lstm_layer_forward(args, res, **kw),
                lambda o, **kw: K7.lstm_layer_backward(
                    args, o[0], o[3], o[4], *cots, **kw), rows)
        if hasattr(K7, "gemm_tc"):
            x2, w, bias = args[0].view(b * t, din), args[1], args[2]
            k7["input_product"] = {
                "addmm_ms": cuda_ms(lambda: torch.addmm(bias, x2, w)),
                "gemm_tc_ms": cuda_ms(lambda: K7.gemm_tc(x2, w, bias)),
                "gemm_tc_max_abs_err": float(
                    (K7.gemm_tc(x2, w, bias) - torch.addmm(bias, x2, w))
                    .abs().max())}
        record[name] = k7
        del args, cots

    if takes_rows:
        record["resident"] = {
            "k9_l2": [K9.layout(0, 2, bw)[0] for bw in (False, True)],
            "k9_l3": [K9.layout(0, 3, bw)[0] for bw in (False, True)],
            "k7_h256": [K7.layout(0, 256, bw)[0] for bw in (False, True)],
            "k7_h128": [K7.layout(0, 128, bw)[0] for bw in (False, True)]}
    record["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
