#!/usr/bin/env python3
"""The bf16-training phases of ``chip_smoke.py`` alone, on one CUDA card.

Run from the root of a checkout of the PyTorch port:

    python3 tools/bf16_phases.py [lws] [flagship] [gru] [recurrence]
        [dw0] [cardcpu] [cardcpu_gru] [cardcpu_lws1] [cardcpu_lws0]
        [cardcpu_p20] [cardcpu_shapes]

builds the libraries the phases launch (all eight at once), then runs,
each part as ``chip_smoke.py`` runs it (the default: ``lws flagship``):
with ``lws`` or ``flagship`` phase 29 (the bf16 modes of K7, K9, K3/K4
and K5/K6 against their plain bf16 versions, timed beside the f32
kernels, cuDNN and SDPA in bf16); with ``recurrence`` phase 29b (the
bf16 modes of K10 and K8, beside the f32 kernels and cuDNN in bf16);
with ``lws`` phase 12 (the f32 lws step, for the times beside), phase
30 (the bf16 lws step) and phase 13d (the lws CLI with
``trainer.precision=bf16``); with ``flagship`` phase 8 (the f32
flagship step), phase 31 (the bf16 flagship step) and phase 9d (the
flagship CLI with ``trainer.precision=bf16``); with ``gru`` phase 16
(the f32 GRU step), phase 32 (its bf16 step) and phase 17b (the GRU CLI
with ``trainer.precision=bf16``); with ``dw0`` phase 20's bf16 steps
under ``MRGEN_FUSED_DW=0`` (the flagship's and lws's, card against
CPU); with ``cardcpu`` phase 31's check of the card's bf16 SGD step
against the same step on CPU tensors (B2 x T48) from the models and
batches of several seeds (``card_vs_cpu``), with ``cardcpu_gru`` phase
32's, with ``cardcpu_lws1`` and ``cardcpu_lws0`` lstm_with_sampling's
under ``MRGEN_FUSED_DW`` 1 (phase 30's) and 0 (phase 20's); with
``cardcpu_shapes`` the bf16 steps of phase 40's configurations (the GRU
Metaformer at hidden 192 and 4 heads, lws at hidden 192 and sampler 192,
the flagship at 2 heads: ``chip_smoke.shape_model_specs``) over six
seeds; with ``cardcpu_p20`` the lws and flagship bf16 steps at phase
20's model and batch under both flags, each parameter's error
(``card_vs_cpu_at``). The CLI phases run on a corpus written under ``_build/cli_run`` and deleted
after. Each phase draws from the generator ``chip_smoke.py`` gives it.
The last line is one JSON object: the bf16 kernels' records and the
steps' and CLI runs'.
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


def card_vs_cpu(cs, dev, seeds, spec=None, f32=None, flag=None):
    """A bf16 SGD step at B2 x T48 on the card against the same step on
    CPU tensors, as phases 31, 32, 30 and 20 read it (``spec``: the
    flagship's by default; ``f32``: its f32 twin), from the model and
    batch of each seed, with ``MRGEN_FUSED_DW`` set to ``flag`` where
    given: the card's step with cuBLAS's bf16 partial sums in f32 (as the
    step keeps them, ``harness.bf16_sums_in_f32``) and in bf16 (PyTorch's
    default), each against the CPU's bf16 step and, as the control, the
    CPU's f32 step; and the CPU's bf16 step with one element of the audio
    input moved by one bf16 ulp against the CPU's bf16 step (the step's
    own sensitivity). Largest error of each gradient over its largest
    magnitude (``grad_rel_errs``, the spec's floor) and the mean over the
    parameters (``grad_mean_rel``)."""
    from multimodalreactiongeneration_tpu_torch.train import harness

    spec = spec or cs.metaformer_bf16_train_spec()
    f32 = f32 or cs.metaformer_train_spec()
    sgd = dict(use_optimizer="sgd", lr=1e-2, momentum=0.9, weight_decay=0.0)
    floor = spec.get("grad_floor", 1e-4)

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
        with cs.fused_dw(flag) if flag else contextlib.nullcontext():
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
                    cs.spec_step_fns(spec, card, sgd)[0](
                        cs.to_device(small, dev))
                finally:
                    harness.bf16_sums_in_f32 = kept
                row[sums] = dict(vs_cpu_bf16=read(card, cpu),
                                 vs_cpu_f32=read(card, cpu32))
                del card
        cs.log("card_vs_cpu", tag=spec["tag"], flag=flag, **row)
        rows.append(row)
    return rows


def card_vs_cpu_at(cs, dev, spec, f32, flag, batch_seed):
    """``spec``'s bf16 SGD step on the card against the same step on CPU
    tensors and the CPU's f32 step (the control), from the model of seed
    ``cs.SEED`` on a B2 x T48 batch of generator ``batch_seed`` (phase
    20's: ``cs.SEED + 20``), under ``MRGEN_FUSED_DW=flag``: the largest
    error over the parameters (floored at 1e-4 and at 1e-2 of the largest
    gradient of all), the mean, and the six parameters with the largest
    errors, each with its scale and the f32 step's error."""
    sgd = dict(use_optimizer="sgd", lr=1e-2, momentum=0.9, weight_decay=0.0)
    host = cs.spec_batch(spec, np.random.default_rng(batch_seed), 2,
                         frames=48)
    with cs.fused_dw(flag):
        cpu = cs.spec_model(spec, "cpu")
        card, cpu32 = copy.deepcopy(cpu).to(dev), copy.deepcopy(cpu)
        cs.spec_step_fns(spec, card, sgd)[0](cs.to_device(host, dev))
        cs.spec_step_fns(spec, cpu, sgd)[0](host)
        cs.spec_step_fns(f32, cpu32, sgd)[0](host)
    largest = max(float(p.grad.abs().max()) for p in cpu.parameters())
    rows = []
    for (name, a), b, c in zip(card.named_parameters(), cpu.parameters(),
                               cpu32.parameters()):
        scale = float(b.grad.abs().max())
        rows.append(dict(
            err=float((a.grad.cpu() - b.grad).abs().max()) / scale,
            name=name, scale_of_largest=scale / largest,
            f32_step_err=float((c.grad - b.grad).abs().max()) / scale))
    rows.sort(key=lambda r: -r["err"])
    out = dict(tag=spec["tag"], flag=flag,
               max_floor_1e4=cs.grad_rel_errs(card, cpu, 1e-4),
               max_floor_1e2=cs.grad_rel_errs(card, cpu, 1e-2),
               mean=cs.grad_mean_rel(card, cpu),
               f32_step_mean=cs.grad_mean_rel(cpu32, cpu), top=rows[:6])
    cs.log("card_vs_cpu_at", **out)
    return out


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
            "attention_bf16", "decode_rollout", "gru",
            "lstm_recurrence")).items():
        cs.log("build", kernel=name, seconds=f"{seconds:.1f}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = {"K1": K1, "K2": K2, "K5": K5, "K7": K7, "K8": K8, "K9": K9,
            "K10": K10}
    dev = torch.device("cuda", 0)
    out = {}
    rng29 = np.random.default_rng(cs.SEED + 29)
    if {"lws", "flagship"} & set(parts):
        k7, k9, stack, attention = cs.bf16_kernel_phase(mods, dev, rng29)
    if "recurrence" in parts:
        k10, k8 = cs.bf16_recurrence_phase(mods, dev, rng29)
        out["recurrence_bf16"] = dict(k10=k10, k8=k8)
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
                kernels_lws=cs.bf16_records(
                    {"lstm_layer_bf16": (k7, cli["launches"]),
                     "lstm_stacked_bf16": (k9, cli["launches"])},
                    train_step=step["launches"]),
                lws_bf16_train_step=step["record"],
                lws_train_step=f32["record"], lws_bf16_cli=cli["record"])
        if "cardcpu" in parts:
            out["card_vs_cpu"] = card_vs_cpu(cs, dev, range(4))
        if "cardcpu_gru" in parts:
            out["card_vs_cpu_gru"] = card_vs_cpu(
                cs, dev, range(4), cs.gru_bf16_train_spec(),
                cs.gru_train_spec())
        if "cardcpu_p20" in parts:
            out["card_vs_cpu_p20"] = [
                card_vs_cpu_at(cs, dev, spec(), f32(), flag, cs.SEED + 20)
                for spec, f32 in ((cs.lws_bf16_train_spec, cs.lws_train_spec),
                                  (cs.metaformer_bf16_train_spec,
                                   cs.metaformer_train_spec))
                for flag in ("1", "0")]
        if "cardcpu_shapes" in parts:
            out["card_vs_cpu_shapes"] = {
                name: card_vs_cpu(cs, dev, range(6), half, step)
                for name, step, half in cs.shape_model_specs()
                if half is not None}
        for flag in ("1", "0"):  # lws, on K7's and on K8's route
            if f"cardcpu_lws{flag}" in parts:
                out[f"card_vs_cpu_lws_fused_dw_{flag}"] = card_vs_cpu(
                    cs, dev, range(4), cs.lws_bf16_train_spec(),
                    cs.lws_train_spec(), flag)
        if "dw0" in parts:
            out["bf16_fused_dw_0"] = {
                "flagship": cs.fused_dw_off_bf16_phase(
                    mods, dev, cs.metaformer_bf16_train_spec())["record"],
                "lws": cs.fused_dw_off_bf16_phase(
                    mods, dev, cs.lws_bf16_train_spec())["record"]}
        if "gru" in parts:
            f32 = cs.train_path_phase(mods, dev,
                                      np.random.default_rng(cs.SEED),
                                      cs.gru_train_spec())
            step = cs.bf16_step_phase(
                mods, dev, np.random.default_rng(cs.SEED + 32),
                cs.gru_bf16_train_spec(), cs.gru_train_spec(),
                "gru_bf16_vs_f32_step")
            cli = cs.cli_phase(mods, run, "configs/lstmformer_gru.yaml",
                               "gru_bf16_cli", ["batch_size=32",
                                                "trainer.precision=bf16"],
                               cs.gru_bf16_cli_launches)
            cli["record"]["checkpoint_dtypes"] = cs.checkpoint_dtypes(
                run, "gru_bf16_cli")
            if "recurrence_bf16" in out:
                out["kernels_recurrence"] = cs.bf16_records(
                    {"gru_bf16": (k10, cli["launches"]),
                     "lstm_recurrence_bf16": (k8, step["launches"])},
                    train_step=step["launches"])
            out.update(
                gru_bf16_train_step=step["record"],
                gru_train_step=f32["record"], gru_bf16_cli=cli["record"])
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
