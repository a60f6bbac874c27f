#!/usr/bin/env python3
"""The bf16-training phases of ``chip_smoke.py`` alone, on one CUDA card.

Run from the root of a checkout of the PyTorch port:

    python3 tools/bf16_phases.py [lws] [flagship] [cardcpu]

builds the libraries the phases launch (all six at once), then runs
(unless ``cardcpu`` is the only part) phase 29 (the bf16 modes of K7,
K9, K3/K4 and K5/K6 against their plain bf16 versions, timed beside the
f32 kernels, cuDNN and SDPA in bf16);
with ``lws`` (the default runs both) phase 12 (the f32 lws step, for the
times beside), phase 30 (the bf16 lws step) and phase 13d (the lws CLI
with ``trainer.precision=bf16``); with ``flagship`` phase 8 (the f32
flagship step), phase 31 (the bf16 flagship step) and phase 9d (the
flagship CLI with ``trainer.precision=bf16``); with ``cardcpu`` (not in
the default) phase 31's check of the card's bf16 SGD step against the
same step on CPU tensors (B2 x T48) from the models and batches of
several seeds (``card_vs_cpu``). The CLI phases run on a
corpus written under ``_build/cli_run`` and deleted after. Each phase
draws from the generator ``chip_smoke.py`` gives it. The last line is one
JSON object: the bf16 kernels' records and the steps' and CLI runs'.
"""
import contextlib
import copy
import json
import shutil
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")


def card_vs_cpu(cs, dev, seeds):
    """The flagship's bf16 SGD step at B2 x T48 on the card against the
    same step on CPU tensors, as phase 31 reads it, from the model and
    batch of each seed: the card's step with cuBLAS's bf16 partial sums in
    f32 (as the step keeps them, ``harness.bf16_sums_in_f32``) and in bf16
    (PyTorch's default), each against the CPU's bf16 step and, as the
    control, the CPU's f32 step; and the CPU's bf16 step with one element
    of the audio input moved by one bf16 ulp against the CPU's bf16 step
    (the step's own sensitivity). Largest error of each gradient over its
    largest magnitude (``grad_rel_errs``, phase 31's floor) and the mean
    over the parameters (``grad_mean_rel``)."""
    from multimodalreactiongeneration_tpu_torch.train import harness

    spec, f32 = cs.metaformer_bf16_train_spec(), cs.metaformer_train_spec()
    sgd = dict(use_optimizer="sgd", lr=1e-2, momentum=0.9, weight_decay=0.0)
    floor = spec["grad_floor"]

    def model(seed, device="cpu"):
        return spec["model"](spec["cfg"],
                             generator=torch.Generator().manual_seed(seed),
                             device=device)

    def read(got, ref):
        worst, name = cs.grad_rel_errs(got, ref, floor)
        return dict(max=worst, worst=name, mean=cs.grad_mean_rel(got, ref))

    rows = []
    for seed in seeds:
        small = cs.spec_batch(spec, np.random.default_rng(seed), 2,
                              frames=48)
        moved = [(x.clone(), n) for x, n in small]
        one = moved[0][0][0, 0, :1].to(torch.bfloat16)
        moved[0][0][0, 0, 0] = (one.view(torch.int16) + 1).view(
            torch.bfloat16).float()[0]
        cpu, cpu32, cpu_moved = model(seed), model(seed), model(seed)
        cs.spec_step_fns(spec, cpu, sgd)[0](small)
        cs.spec_step_fns(f32, cpu32, sgd)[0](small)
        cs.spec_step_fns(spec, cpu_moved, sgd)[0](moved)
        row = dict(seed=seed, cpu_one_bf16_ulp=read(cpu_moved, cpu))
        for sums, ctx in (("f32_sums", harness.bf16_sums_in_f32),
                          ("bf16_sums", contextlib.nullcontext)):
            card = copy.deepcopy(model(seed)).to(dev)
            kept = harness.bf16_sums_in_f32
            harness.bf16_sums_in_f32 = ctx
            try:
                cs.spec_step_fns(spec, card, sgd)[0](cs.to_device(small, dev))
            finally:
                harness.bf16_sums_in_f32 = kept
            row[sums] = dict(vs_cpu_bf16=read(card, cpu),
                             vs_cpu_f32=read(card, cpu32))
            del card
        cs.log("card_vs_cpu", **row)
        rows.append(row)
    return rows


def main(parts):
    import chip_smoke as cs
    from multimodalreactiongeneration_tpu_torch import _build
    from multimodalreactiongeneration_tpu_torch.ops import (
        decode_rollout as K2,
        gru as K10,
        lstm_layer as K7,
        lstm_recurrence as K8,
        lstm_stacked as K9,
        mixer_stack as K1,
        rect_attention as K5,
    )

    if not torch.cuda.is_available():
        raise RuntimeError("bf16_phases: no CUDA device; nothing was run")
    t0 = time.perf_counter()
    for name, seconds in _build.build_all((
            "lstm_layer", "lstm_stacked", "mixer_stack", "rect_attention",
            "attention_bf16", "decode_rollout")).items():
        cs.log("build", kernel=name, seconds=f"{seconds:.1f}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = {"K1": K1, "K2": K2, "K5": K5, "K7": K7, "K8": K8, "K9": K9,
            "K10": K10}
    dev = torch.device("cuda", 0)
    out = {}
    if parts != ("cardcpu",):
        k7, k9, stack, attention = cs.bf16_kernel_phase(
            mods, dev, np.random.default_rng(cs.SEED + 29))
    run = _build.BUILD_DIR / "cli_run"
    shutil.rmtree(run, ignore_errors=True)
    run.mkdir(parents=True)
    try:
        cs.write_corpus(str(run / "corpus"))
        if "lws" in parts:
            f32 = cs.train_path_phase(mods, dev,
                                      np.random.default_rng(cs.SEED),
                                      cs.lws_train_spec())
            step = cs.bf16_step_phase(
                mods, dev, np.random.default_rng(cs.SEED + 30),
                cs.lws_bf16_train_spec(), cs.lws_train_spec(),
                "lws_bf16_vs_f32_step")
            cli = cs.cli_phase(mods, run, "configs/lstm_with_sampling.yaml",
                               "lws_bf16_cli", ["exp.batch_size=32",
                                                "trainer.precision=bf16"],
                               cs.lws_bf16_cli_launches)
            out.update(
                kernels_lws=cs.bf16_records(k7, k9, cli["launches"],
                                            train_step=step["launches"]),
                lws_bf16_train_step=step["record"],
                lws_train_step=f32["record"], lws_bf16_cli=cli["record"])
        if "cardcpu" in parts:
            out["card_vs_cpu"] = card_vs_cpu(cs, dev, range(4))
        if "flagship" in parts:
            f32 = cs.train_path_phase(mods, dev,
                                      np.random.default_rng(cs.SEED),
                                      cs.metaformer_train_spec())
            step = cs.bf16_step_phase(
                mods, dev, np.random.default_rng(cs.SEED + 31),
                cs.metaformer_bf16_train_spec(), cs.metaformer_train_spec(),
                "bf16_vs_f32_step")
            cli = cs.cli_phase(mods, run, "configs/lstmformer.yaml",
                               "bf16_cli", ["batch_size=32",
                                            "trainer.precision=bf16"],
                               cs.metaformer_bf16_cli_launches)
            cli["record"]["checkpoint_dtypes"] = cs.checkpoint_dtypes(
                run, "bf16_cli")
            out.update(
                kernels_flagship=cs.flagship_bf16_records(
                    stack, attention, cli["launches"],
                    train_step=step["launches"]),
                bf16_train_step=step["record"], train_step=f32["record"],
                bf16_cli=cli["record"])
    finally:
        shutil.rmtree(run)
    print(json.dumps({**out, "seconds": time.perf_counter() - t0}))
    print(cs.card_line())


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or ("lws", "flagship"))
