#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path, offline AR generation with the flagship
Metaformer at full width (``configs.LSTMFORMER_MODEL_CFG``: hidden 256,
5 blocks, encoders of 5 mixer blocks, 4 heads, 10 s context) on random
weights from a seeded generator, in phases:

  0. device: name and power limit; TF32 off;
  1. build both CUDA kernels from csrc/ (timed);
  2. mixer-stack kernel vs its plain version, f32, B16 x H256 x L5 at
     T2096 (audio encoder) and T262 (partner-motion encoder): <= 1e-4
     (sums taken in another order over 5 x 2096 sequential cells);
  3. decode-rollout kernel vs its plain version at B16 x T250,
     teacher-forced: f32 kernel vs f32 plain <= 1e-4; bf16 kernel vs
     f32 plain <= 5e-2 (the JAX package's bf16 drift bound);
  4. main path: ``generate_metaformer`` with the full mask and bf16
     caches on 3 batches of 16 x 250 frames (lead 12): shape, finite,
     launch counts (mixer stack +2, rollout +1 per generation), time
     per generation; then a teacher-forced f32 generation at batch 2
     against the same weights and inputs on CPU tensors (the all-plain
     path): <= 1e-4.

Any failure raises. The last lines are the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
Run from the repository root: ``python3 chip_smoke.py``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

B, FRAMES, LEAD, RATIO = 16, 250, 12, 8
AUDIO_DIM, MOTION_DIM = 81, 18
SEED = 0
K1_TOL, K2_F32_TOL, K2_BF16_TOL, PATH_TOL = 1e-4, 1e-4, 5e-2, 1e-4


def log(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def make_batch(rng, batch, frames=FRAMES, lead=LEAD):
    shapes = [
        (batch, frames * RATIO, AUDIO_DIM), (batch, frames, MOTION_DIM),
        (batch, frames, MOTION_DIM), (batch, lead * RATIO, AUDIO_DIM),
        (batch, lead, MOTION_DIM), (batch, lead, MOTION_DIM),
        (batch, frames, MOTION_DIM),
    ]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]


def cuda_ms(fn, reps):
    """Mean milliseconds per call by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def max_err(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; nothing was run")
    from multimodalreactiongeneration_tpu_torch import _build
    from multimodalreactiongeneration_tpu_torch.configs import (
        LSTMFORMER_MODEL_CFG,
    )
    from multimodalreactiongeneration_tpu_torch.infer import generate as G
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )
    from multimodalreactiongeneration_tpu_torch.ops import (
        decode_rollout as K2,
        mixer_stack as K1,
    )

    # ---- 0. device ---------------------------------------------------
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", card=repr(card), torch_name=repr(kind),
        torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 1. build ----------------------------------------------------
    t0 = time.perf_counter()
    for name in ("mixer_stack", "decode_rollout"):
        t1 = time.perf_counter()
        _build.load(name)
        log("build", kernel=name, seconds=f"{time.perf_counter() - t1:.1f}")
        for line in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("   ", line.strip())
    log("build", total_seconds=f"{time.perf_counter() - t0:.1f}")

    cfg = LSTMFORMER_MODEL_CFG
    gen = torch.Generator().manual_seed(SEED)
    model = Metaformer(cfg, generator=gen, device=dev)
    rng = np.random.default_rng(SEED)

    # ---- 2. mixer stack vs plain -------------------------------------
    stack = model.metaformer.block_0.emb_1
    blocks = [getattr(stack, f"block_{i}") for i in range(stack.num_layerd)]

    def st(fn):
        return torch.stack([fn(b) for b in blocks]).float().contiguous()

    weights = (
        st(lambda b: b.mixer.weight_ih_l0.T),
        st(lambda b: b.mixer.bias_ih_l0 + b.mixer.bias_hh_l0),
        st(lambda b: b.mixer.weight_hh_l0.T),
        st(lambda b: b.feed_forward.feedforward.weight.T),
        st(lambda b: b.feed_forward.feedforward.bias),
        st(lambda b: b.mixer_norm.weight),
        st(lambda b: b.mixer_norm.bias),
        st(lambda b: b.feed_forward.LayerNorm_0.weight),
        st(lambda b: b.feed_forward.LayerNorm_0.bias),
    )
    k1_cases = []
    nl, hid = len(blocks), cfg["hidden_size"]
    for t in ((LEAD + FRAMES) * RATIO, LEAD + FRAMES):
        x0 = torch.from_numpy(
            rng.standard_normal((B, t, hid)).astype(np.float32)).to(dev)
        h0 = torch.from_numpy(
            0.3 * rng.standard_normal((nl, B, hid)).astype(np.float32)).to(dev)
        c0 = torch.from_numpy(
            0.3 * rng.standard_normal((nl, B, hid)).astype(np.float32)).to(dev)
        args = (x0, *weights, h0, c0)
        with torch.no_grad():
            ms, (y, (hn, cn)) = cuda_ms(
                lambda: K1.mixer_stack_forward(*args), 5)
            plain_ms, (yr, (hr, cr)) = cuda_ms(
                lambda: K1.mixer_stack_forward_reference(*args), 1)
        err = max_err((y, hn, cn), (yr, hr, cr))
        log("mixer_stack", T=t, max_abs_err=f"{err:.3e}", ms=f"{ms:.3f}",
            plain_ms=f"{plain_ms:.3f}")
        if not err <= K1_TOL:
            raise AssertionError(f"mixer_stack T={t}: {err} > {K1_TOL}")
        k1_cases.append(dict(T=t, max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # ---- 3. decode rollout vs plain ----------------------------------
    batch = [x.to(dev) for x in make_batch(rng, B)]
    teacher = G.sampling_mask_for(FRAMES, "teacher", device=dev)
    rollout = {}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            states, ea, em, ms_, la, lm = G._hoist_and_warmup(model, batch, dt)
            rollout[dt] = G._fused_rollout_args(
                model, states, ea, em, ms_, teacher, dt, la, lm)
        a32, kw = rollout[torch.float32]
        plain_ms, ref = cuda_ms(
            lambda: K2.decode_rollout_reference(*a32, **kw), 1)
        k2_cases = []
        for dt, tol in ((torch.float32, K2_F32_TOL),
                        (torch.bfloat16, K2_BF16_TOL)):
            a, kw_dt = rollout[dt]
            ms, out = cuda_ms(lambda: K2.decode_rollout(*a, **kw_dt), 3)
            case = {}
            if dt == torch.bfloat16:
                plain_bf16_ms, ref_bf16 = cuda_ms(
                    lambda: K2.decode_rollout_reference(*a, **kw_dt), 1)
                # same numerics on both sides: reported, not gated
                case["max_abs_err_vs_plain_bf16"] = max_err((out,), (ref_bf16,))
            err = max_err((out,), (ref,))
            name = str(dt).replace("torch.", "")
            log("decode_rollout", dtype=name, max_abs_err=f"{err:.3e}",
                ms=f"{ms:.3f}", plain_f32_ms=f"{plain_ms:.3f}",
                **{k: f"{v:.3e}" for k, v in case.items()})
            if not err <= tol:
                raise AssertionError(f"decode_rollout {name}: {err} > {tol}")
            k2_cases.append(dict(dtype=name, max_abs_err=err, ms=ms, **case))
        k2_cases[0]["plain_ms"] = plain_ms
        k2_cases[1]["plain_ms"] = plain_bf16_ms
        log("decode_rollout", plain_bf16_ms=f"{plain_bf16_ms:.3f}")

    # ---- 4. main path ------------------------------------------------
    full = G.sampling_mask_for(FRAMES, "full", device=dev)
    batches = [[x.to(dev) for x in make_batch(rng, B)] for _ in range(3)]
    G.generate_metaformer(model, batches[0], full)  # warm-up, not counted
    torch.cuda.synchronize()
    K1.launches = 0
    K2.launches = 0
    times = []
    for i, bd in enumerate(batches):
        k1_before, k2_before = K1.launches, K2.launches
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        pred = G.generate_metaformer(model, bd, full)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        if tuple(pred.shape) != (B, FRAMES, MOTION_DIM):
            raise AssertionError(f"generation {i}: shape {tuple(pred.shape)}")
        if not bool(torch.isfinite(pred).all()):
            raise AssertionError(f"generation {i}: non-finite output")
        d1, d2 = K1.launches - k1_before, K2.launches - k2_before
        if (d1, d2) != (2, 1):
            raise AssertionError(
                f"generation {i}: launches mixer_stack +{d1}, "
                f"decode_rollout +{d2} (want +2, +1)")
        log("generate", batch=i, shape=tuple(pred.shape), finite=True,
            ms=f"{times[-1]:.3f}", mixer_stack_launches=f"+{d1}",
            decode_rollout_launches=f"+{d2}")
    launches = {"mixer_stack": K1.launches, "decode_rollout": K2.launches}
    gen_ms = float(np.mean(times))
    log("generate", ms_per_generation=f"{gen_ms:.3f}",
        frames_per_s=f"{B * FRAMES / (gen_ms / 1000):.1f}",
        card=repr(card), launches=launches)

    small = make_batch(rng, 2)
    teacher_cpu = G.sampling_mask_for(FRAMES, "teacher")
    on_card = G.generate_metaformer(
        model, [x.to(dev) for x in small], teacher_cpu.to(dev),
        cache_dtype=torch.float32)
    model_cpu = Metaformer(cfg, generator=torch.Generator().manual_seed(SEED))
    on_cpu = G.generate_metaformer(model_cpu, small, teacher_cpu,
                                   cache_dtype=torch.float32)
    err = float((on_card.cpu() - on_cpu).abs().max())
    log("generate", teacher_f32_batch2_vs_cpu_max_abs_err=f"{err:.3e}")
    if not err <= PATH_TOL:
        raise AssertionError(f"card vs CPU generation: {err} > {PATH_TOL}")

    k1_main, k2_main = k1_cases[0], k2_cases[1]
    record = {"kernels": [
        {
            "name": "mixer_stack", "route": "cuda",
            "source": "multimodalreactiongeneration_tpu_torch/csrc/mixer_stack.cu",
            "replaces": "multimodalreactiongeneration_tpu/ops/pallas_mixer_stack.py:215",
            "launches": launches["mixer_stack"],
            "max_abs_err": max(c["max_abs_err"] for c in k1_cases),
            "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
            "cases": k1_cases,
        },
        {
            "name": "decode_rollout", "route": "cuda",
            "source": "multimodalreactiongeneration_tpu_torch/csrc/decode_rollout.cu",
            "replaces": "multimodalreactiongeneration_tpu/ops/pallas_decode_rollout.py:103",
            "launches": launches["decode_rollout"],
            "max_abs_err": max(c["max_abs_err"] for c in k2_cases),
            "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
            "cases": k2_cases,
        },
    ], "generation": {"batch": B, "frames": FRAMES, "ms": gen_ms,
                      "frames_per_s": B * FRAMES / (gen_ms / 1000)}}
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
