#!/usr/bin/env python3
"""The ``MRGEN_FUSED_DW=0`` training steps against the default ones, at
several batch seeds, for the checkout in the current directory.

Run from the root of a checkout of the PyTorch port, on one CUDA card:

    python3 <this file> TAG [--seeds N] [--seed S] [--plain [--full-batch]]
        [--time] [--rollout]

``chip_smoke.py`` phase 20 runs one ``MRGEN_FUSED_DW=0`` training step of
the flagship Metaformer and of simple_lstm (their single-layer LSTMs on
K8) against the default step (K7) on the same weights and batch, and
holds every gradient within 1e-3 of its parameter's largest: a gate that
reads K8's rounding through the whole model. This repeats that
comparison on the batches of seeds 0 .. N-1 (default 3; ``--seed S``
adds seed S before them, 20 being phase 20's own) and also counts
the inputs of every ``torch.relu`` of the two forwards whose sign
differs: a flipped ReLU moves its parameter's gradient by a discrete
amount, whatever the size of the rounding that flipped it. Prints one
JSON line: TAG, the card's name and power limit, and per model and seed
the loss's relative difference, the worst gradient's and its parameter,
the ReLU inputs, how many flipped and the largest magnitude among them
(each seed's entry also goes to standard error as it is measured).
``--plain`` instead holds each flag's step to the plain FP32 step (the
same weights and batch on CPU tensors) at phase 20's batch of each model
(the spec's ``dw0_batch``), as phase 20 does, or with ``--full-batch``
at the batch of the model's training step: per model, seed and flag the
loss's relative difference from the plain step's, the worst gradient's,
and the ReLU inputs whose sign differs from the plain step's; beside
them the flags' distance from each other, and the plain step's seconds.
``--time`` instead times each model's training step, with its yaml's
optimizer on the batch of seed 0, under ``MRGEN_FUSED_DW=1`` and ``=0``
in turns (1, 0, 0, 1): host clock to a synchronize, the mean of 5 steps
after one warm-up step, ms. ``--rollout`` instead times ``chip_smoke.py``
phase 19's ``MRGEN_FUSED_DW=0`` rollout: simple_lstm's
``sliding_window_generate`` over ``DW0_FRAMES`` frames at batch 1 (K8 x4
a frame under ``=0``, K7 x4 under ``=1``), the flags in turns (0, 1, 1,
0), one 8-frame warm-up rollout under each flag first; host clock to a
synchronize, ms. With it, the host time of one K8 forward without
residuals at the rollout's B1 x T120 x H128: the mean over 200 calls,
host clock up to the return of the last (the calls queue on the card
unsynchronized), us. Run it from two checkouts in turns (parent, change,
change, parent) to compare the rollouts.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

RELU = torch.relu


def recording_relu(model, log):
    """torch.relu that appends a copy of each input to ``log``, also set
    as the activation of every module of ``model`` that holds torch.relu
    (the modules that call torch.relu by name see it while it is
    installed as torch.relu)."""
    def relu(x):
        log.append(x.detach().clone())
        return RELU(x)
    for m in model.modules():
        if getattr(m, "act", None) is RELU:
            m.act = relu
    return relu


def compare(cs, spec, dev, seed):
    """The phase-20 comparison on the batch of ``seed``, with ReLU flips."""
    batch = cs.spec_batch(spec, np.random.default_rng(seed), spec["batch"],
                          dev)
    sgd0 = dict(use_optimizer="sgd", lr=0.0, momentum=0.0, weight_decay=0.0)
    runs = {}
    for flag in ("1", "0"):
        model = cs.spec_model(spec, dev)
        train_step, _ = cs.spec_step_fns(spec, model, sgd0)
        log = []
        torch.relu = recording_relu(model, log)
        try:
            with cs.fused_dw(flag):
                loss, _ = train_step(batch)
        finally:
            torch.relu = RELU
        torch.cuda.synchronize()
        runs[flag] = (float(loss), model, log)
    (loss_on, model_on, on), (loss_off, model_off, off) = runs["1"], runs["0"]
    worst, name = cs.grad_rel_errs(model_off, model_on)
    flipped = [a[(a > 0) != (b > 0)] for a, b in zip(on, off)]
    return {"loss_rel_err": abs(loss_off - loss_on) / abs(loss_on),
            "grad_max_rel_err": worst, "worst": name,
            "relu_inputs": sum(a.numel() for a in on),
            "relu_sign_flips": sum(f.numel() for f in flipped),
            "largest_flipped_input": max(
                (float(f.abs().max()) for f in flipped if f.numel()),
                default=0.0)}


def card_step(cs, spec, model, batch, flag):
    """(loss, ReLU inputs) of one lr-0 SGD step of ``model`` under
    MRGEN_FUSED_DW=flag (the flag does not reach CPU tensors)."""
    sgd0 = dict(use_optimizer="sgd", lr=0.0, momentum=0.0, weight_decay=0.0)
    train_step, _ = cs.spec_step_fns(spec, model, sgd0)
    log = []
    torch.relu = recording_relu(model, log)
    try:
        with cs.fused_dw(flag):
            loss, _ = train_step(batch)
    finally:
        torch.relu = RELU
    if batch_device(batch).type == "cuda":
        torch.cuda.synchronize()
    return float(loss), [x.cpu() for x in log]


def batch_device(batch):
    first = batch[0]
    return (first[0] if isinstance(first, tuple) else first).device


def flips(a_log, b_log):
    """(sign flips, largest flipped magnitude) between two ReLU logs."""
    flipped = [a[(a > 0) != (b > 0)] for a, b in zip(a_log, b_log)]
    return (sum(f.numel() for f in flipped),
            max((float(f.abs().max()) for f in flipped if f.numel()),
                default=0.0))


def compare_plain(cs, spec, dev, seed, full_batch=False):
    """Phase 20's comparison on the batch of ``seed``: each flag's card
    step against the plain FP32 step on CPU tensors."""
    rows, frames = ((spec["batch"], spec["frames"]) if full_batch
                    else spec["dw0_batch"])
    host = cs.spec_batch(spec, np.random.default_rng(seed), rows,
                         frames=frames)
    t0 = time.perf_counter()
    plain = cs.spec_model(spec, "cpu")
    loss_plain, plain_log = card_step(cs, spec, plain, host, "1")
    out = {"plain_step_s": time.perf_counter() - t0,
           "relu_inputs": sum(a.numel() for a in plain_log)}
    models = {}
    for flag in ("1", "0"):
        model = cs.spec_model(spec, dev)
        loss, log = card_step(cs, spec, model, cs.to_device(host, dev), flag)
        worst, name = cs.grad_rel_errs(model, plain)
        n, largest = flips(log, plain_log)
        out[f"fused_dw_{flag}"] = {
            "loss_rel_err": abs(loss - loss_plain) / abs(loss_plain),
            "grad_max_rel_err": worst, "worst": name,
            "relu_sign_flips": n, "largest_flipped_input": largest}
        models[flag] = model
    out["fused_dw_0_vs_1_grad_max_rel_err"] = cs.grad_rel_errs(
        models["0"], models["1"])[0]
    return out


def step_times(cs, spec, dev, steps=5):
    """{flag: [ms, ms]}: the step's mean time under MRGEN_FUSED_DW=flag,
    the flags in turns 1, 0, 0, 1, one model and batch each turn."""
    out = {"1": [], "0": []}
    for flag in ("1", "0", "0", "1"):
        model = cs.spec_model(spec, dev)
        train_step, _ = cs.spec_step_fns(spec, model, spec["optim"])
        batch = cs.spec_batch(spec, np.random.default_rng(0), spec["batch"],
                              dev)
        with cs.fused_dw(flag):
            train_step(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                train_step(batch)
            torch.cuda.synchronize()
        out[flag].append((time.perf_counter() - t0) * 1e3 / steps)
        del model, train_step
    return out


def rollout_times(cs, dev):
    """{flag: [ms, ms]}: the DW0_FRAMES rollout under MRGEN_FUSED_DW=flag,
    the flags in turns 0, 1, 1, 0, one model and its inputs throughout;
    and the host us of one K8 forward call."""
    from multimodalreactiongeneration_tpu_torch.configs import (
        SIMPLE_LSTM_MODEL_CFG,
    )
    from multimodalreactiongeneration_tpu_torch.infer.simple_generate import (
        audio_windows,
        sliding_window_generate,
    )
    from multimodalreactiongeneration_tpu_torch.models.simple_lstm import (
        SimpleLSTM,
    )
    from multimodalreactiongeneration_tpu_torch.ops import (
        lstm_recurrence as K8,
    )

    model = SimpleLSTM(SIMPLE_LSTM_MODEL_CFG,
                       generator=torch.Generator().manual_seed(cs.SEED),
                       device=dev)
    rng = np.random.default_rng(0)
    fbank = torch.from_numpy(rng.standard_normal(
        (cs.FRAMES * cs.RATIO + cs.SIMPLE_AUDIO_T, cs.AUDIO_DIM)).astype(
            np.float32))
    ctx = torch.from_numpy(rng.standard_normal(
        (cs.SIMPLE_CONTEXT, cs.MOTION_DIM)).astype(np.float32))
    windows = audio_windows(fbank, cs.FRAMES, cs.RATIO, cs.SIMPLE_AUDIO_T)
    out = {"0": [], "1": []}
    for flag in out:
        with cs.fused_dw(flag):
            sliding_window_generate(model, windows[:8], ctx)
    for flag in ("0", "1", "1", "0"):
        with cs.fused_dw(flag):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sliding_window_generate(model, windows[:cs.DW0_FRAMES], ctx)
            torch.cuda.synchronize()
        out[flag].append((time.perf_counter() - t0) * 1e3)
    h, calls = 128, 200
    args = [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev) * s for shape, s in (
            ((1, cs.SIMPLE_AUDIO_T, 4 * h), 0.5), ((h, 4 * h), 0.06),
            ((1, h), 0.3), ((1, h), 0.3))]
    K8.lstm_recurrence_forward(args, False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        K8.lstm_recurrence_forward(args, False)
    out["k8_host_us_per_call"] = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return out


def main():
    argv = sys.argv[1:]
    tag = argv[0] if argv and not argv[0].startswith("--") else os.getcwd()
    seeds = list(range(int(argv[argv.index("--seeds") + 1])
                       if "--seeds" in argv else 3))
    if "--seed" in argv:  # one more batch seed, first: 20 is phase 20's
        seeds.insert(0, int(argv[argv.index("--seed") + 1]))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    record = {"tag": tag}
    specs = (cs.metaformer_train_spec(), cs.simple_train_spec())
    if "--rollout" in argv:
        record["simple rollout"] = rollout_times(cs, dev)
        specs = ()
    if "--time" in argv:
        for spec in specs:
            record[spec["tag"]] = step_times(cs, spec, dev)
        specs = ()
    fn = compare
    if "--plain" in argv:
        def fn(cs, spec, dev, seed):
            return compare_plain(cs, spec, dev, seed, "--full-batch" in argv)
    for seed in seeds:  # every model at a seed before the next seed
        for spec in specs:
            key = f"{spec['tag']} seed {seed}"
            record[key] = fn(cs, spec, dev, seed)
            print(json.dumps({key: record[key]}), file=sys.stderr,
                  flush=True)  # a cut run keeps what it measured
    record["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
