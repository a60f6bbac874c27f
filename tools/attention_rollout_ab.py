#!/usr/bin/env python3
"""Time rect attention (K5/K6) and the decode rollout (K2) of the checkout
in the current directory.

Run from the root of a checkout of the PyTorch port, on one CUDA card:

    python3 <this file> TAG [--stages] [--attention-only]

It imports the port from the current directory, so one command can time
two checkouts in turns (parent, change, change, parent: unpack the other
with ``git archive`` into a directory that ``.gitignore`` lists and run
this file from there). Times are means by CUDA events after a warm-up:

  * K5 forward with and without residuals, and K6, at the flagship
    integrators' shapes, B32 x Lq 252 x Lk {2016, 252}, E 256, 4 heads,
    10% padded rows and keys (as ``chip_smoke.py`` phase 7), with the
    forward's max abs error against the plain version, each of K6's
    launches' device time under torch.profiler by kernel name; then the
    same in the bf16 mode (bf16 q, k, v: ``csrc/attention_bf16.cu``, the
    error against the plain bf16 version), beside SDPA in bf16 on the
    same values and mask (forward, and its backward through autograd);
  * K2 in bf16 and f32 at B16 x 250 steps (one launch) and B64 x 250 (four
    launches) on the flagship Metaformer from seed 0, teacher-forced, with
    the max abs error against the f32 plain version at B16;
  * ``generate_metaformer`` at B16 x 250 frames, lead 12, full mask, bf16
    caches, ms per generation (mean of 3 after a warm-up).

Prints one JSON line with TAG and the card's name and power limit.
``--attention-only`` times K5/K6 alone. With
``--stages``, K2 (bf16, B16) also runs once from a build of its source
with ``-DROLLOUT_STAMPS`` (a checkout whose source has the stamps), and
the JSON gets, per stage of a step (median over the stamped steps): the
time from the first block's release by the previous barrier to the last
block's arrival (``to_barrier_us``), from that arrival to the last
block's release (``in_barrier_us``), the slowest working block's own
time (``work_us``), and the blocks with work and their units; a table of
the same goes to standard error.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

B, FRAMES, LEAD, RATIO = 16, 250, 12, 8
AUDIO_DIM, MOTION_DIM = 81, 18
STAGES = (  # the stages of a metaformer block, then the head's
    ["S1 cell", "S2 LN+FF", "S3 queries", "S4 logits", "S5 context",
     "S6 out fold", "S7 LN+FF", "S8 cat", "S9 FFN in", "S10 FFN out"],
    ["S11 head in", "S12 head out"])


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


def kernel_device_ms(fn, prefix):
    """Device ms of each kernel whose name starts with ``prefix`` in one
    call of ``fn`` (torch.profiler), by name without namespace."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        found = re.search(rf"\b({prefix}\w*)", e.name)
        if e.device_type == DeviceType.CUDA and found:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            out[found.group(1)] = out.get(found.group(1), 0.0) + ms
    return out


def make_batch(rng, batch):
    shapes = [
        (batch, FRAMES * RATIO, AUDIO_DIM), (batch, FRAMES, MOTION_DIM),
        (batch, FRAMES, MOTION_DIM), (batch, LEAD * RATIO, AUDIO_DIM),
        (batch, LEAD, MOTION_DIM), (batch, LEAD, MOTION_DIM),
        (batch, FRAMES, MOTION_DIM),
    ]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]


def attention_times(K5, args, g, plain):
    """K5 with and without residuals and K6 (CUDA-event means of 20), the
    forward's error against ``plain``, and a function giving K6's kernels'
    device ms by name (torch.profiler: called after every CUDA-event
    timing, since a profiler session slows a process's later launches)."""
    ctx, m, l = K5.rect_attention_forward(*args, residuals=True)
    want = plain(*args)
    rec = {
        "fwd_ms": cuda_ms(
            lambda: K5.rect_attention_forward(*args, residuals=True), 20),
        "fwd_no_residual_ms": cuda_ms(
            lambda: K5.rect_attention_forward(*args), 20),
        "bwd_ms": cuda_ms(
            lambda: K5.rect_attention_backward(*args, ctx, m, l, g), 20),
        "fwd_max_abs_err": float((ctx - want).abs().max())}
    del want

    def kernels():
        rec["fwd_kernel_ms"] = kernel_device_ms(
            lambda: K5.rect_attention_forward(*args, residuals=True),
            "rect_attn_fwd")
        rec["bwd_kernels_ms"] = kernel_device_ms(
            lambda: K5.rect_attention_backward(*args, ctx, m, l, g),
            "rect_attn_bwd")
    return rec, kernels


def sdpa_times(K5, args, g):
    """SDPA on the same values and mask (a yardstick the port never
    calls): forward, and its backward through autograd (means of 20)."""
    import torch.nn.functional as F

    heads, q, k, v, q_pad, k_pad = args
    b, dh = q.shape[0], q.shape[2] // heads
    allowed = ~K5.rect_attention_mask(q_pad, k_pad)[:, None]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def split(x):
        return x.view(b, x.shape[1], heads, dh).transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(
            *[split(x) for x in leaves], attn_mask=allowed)

    out = fwd()
    cot = split(g.to(q.dtype))
    rec = {"fwd_ms": cuda_ms(fwd, 20), "bwd_ms": cuda_ms(
        lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True), 20)}
    del out
    return rec


def attention(dev, rng):
    from multimodalreactiongeneration_tpu_torch.ops import rect_attention as K5

    b, lq, e, heads = 32, LEAD + 240, 256, 4
    bf = torch.bfloat16
    out, profiles = {}, []
    for lk in (lq * RATIO, lq):
        def r(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev)
        q, k, v, g = r(b, lq, e), r(b, lk, e), r(b, lk, e), r(b, lq, e)
        q_pad = torch.from_numpy(rng.random((b, lq)) < 0.1).to(dev)
        k_pad = torch.from_numpy(rng.random((b, lk)) < 0.1).to(dev)
        args = (heads, q, k, v, q_pad, k_pad)
        rec, kernels = attention_times(K5, args, g,
                                       K5.rect_attention_reference)
        out[f"lk{lk}"] = rec
        profiles.append(kernels)
        args = (heads, q.to(bf), k.to(bf), v.to(bf), q_pad, k_pad)
        rec["sdpa_bf16"] = sdpa_times(K5, args, g)
        rec["bf16"], kernels = attention_times(
            K5, args, g, K5.rect_attention_bf16_reference)
        profiles.append(kernels)
    for kernels in profiles:
        kernels()
    return out


def rollout_args(model, batch, dtype):
    from multimodalreactiongeneration_tpu_torch.infer import generate as G

    teacher = G.sampling_mask_for(FRAMES, "teacher", device=batch[0].device)
    states, ea, em, ms, la, lm = G._hoist_and_warmup(model, batch, dtype)
    return G._fused_rollout_args(model, states, ea, em, ms, teacher, dtype,
                                 la, lm)


def rollout(model, dev, rng):
    from multimodalreactiongeneration_tpu_torch.ops import decode_rollout as K2

    out = {}
    with torch.no_grad():
        for b in (B, 4 * B):
            batch = [x.to(dev) for x in make_batch(rng, b)]
            ref = None
            for dt in (torch.float32, torch.bfloat16):
                a, kw = rollout_args(model, batch, dt)
                if b == B and dt == torch.float32:
                    ref = K2.decode_rollout_reference(*a, **kw)
                n0 = K2.launches
                got = K2.decode_rollout(*a, **kw)
                rec = {"launches": K2.launches - n0,
                       "ms": cuda_ms(lambda: K2.decode_rollout(*a, **kw),
                                     5 if b == B else 2)}
                if ref is not None:
                    rec["max_abs_err_vs_plain_f32"] = float(
                        (got - ref).abs().max())
                out[f"b{b}_{str(dt).replace('torch.', '')}"] = rec
    return out


def generation(model, dev, rng):
    from multimodalreactiongeneration_tpu_torch.infer import generate as G

    full = G.sampling_mask_for(FRAMES, "full", device=dev)
    batch = [x.to(dev) for x in make_batch(rng, B)]
    return {"ms": cuda_ms(lambda: G.generate_metaformer(model, batch, full),
                          3)}


def stage_table(model, dev, rng):
    """K2 from its stamped build: per stage of a step, medians over the
    stamped steps."""
    import ctypes

    from multimodalreactiongeneration_tpu_torch.ops import decode_rollout as K2

    defines = ("ROLLOUT_STAMPS",)
    lib = K2._lib(defines)
    lib.decode_rollout_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.decode_rollout_stamps.restype = ctypes.c_int
    dims = (ctypes.c_int * 4)()
    if lib.decode_rollout_stamps(None, dims):
        raise RuntimeError("decode_rollout_stamps: reset failed")
    t0, steps, stages, grid = list(dims)
    plain_lib = K2._lib
    K2._lib = functools.partial(plain_lib, defines)
    try:
        with torch.no_grad():
            batch = [x.to(dev) for x in make_batch(rng, B)]
            a, kw = rollout_args(model, batch, torch.bfloat16)
            torch.cuda.synchronize()
            K2.decode_rollout(*a, **kw)
            torch.cuda.synchronize()
    finally:
        K2._lib = plain_lib
    buf = np.zeros((steps, stages, grid, 3), dtype=np.uint64)
    if lib.decode_rollout_stamps(buf.ctypes.data, dims):
        raise RuntimeError("decode_rollout_stamps: read failed")
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return {"stamped_steps": [t0, t0 + steps], "grid": sm,
            **summarize_stamps(buf[:, :, :sm], a[3].shape[0])}


def summarize_stamps(buf, nb):
    """(steps, stages, blocks, [arrive ns, leave ns, units]) -> the stage
    table and the step's sums (medians over the steps)."""
    used = int(np.nonzero(buf[0, :, :, 1].any(axis=1))[0].max()) + 1
    names, head = STAGES
    labels = [f"stage {s}" for s in range(used)]
    if used == len(names) * nb + len(head):
        labels = [f"b{l} {n}" for l in range(nb) for n in names] + head
    arrive = buf[..., 0].astype(np.float64)
    leave = buf[..., 1].astype(np.float64)
    units = buf[..., 2].astype(np.int64)
    steps = buf.shape[0]
    rows = []
    for s in range(used):
        rec = {"to_barrier_us": [], "in_barrier_us": [], "work_us": []}
        for t in range(steps):
            if s == 0 and t == 0:
                continue
            pt, ps = (t, s - 1) if s else (t - 1, used - 1)
            start = leave[pt, ps]
            busy = units[t, s] > 0
            rec["to_barrier_us"].append(
                (arrive[t, s].max() - start.min()) / 1e3)
            rec["in_barrier_us"].append(
                (leave[t, s].max() - arrive[t, s].max()) / 1e3)
            rec["work_us"].append(
                float((arrive[t, s] - start)[busy].max()) / 1e3
                if busy.any() else 0.0)
        rows.append({"stage": labels[s],
                     "blocks_with_work": int((units[1, s] > 0).sum()),
                     "units": int(units[1, s].sum()),
                     **{k: float(np.median(v)) for k, v in rec.items()}})
    step_us = [(leave[t, used - 1].max() - leave[t - 1, used - 1].max()) / 1e3
               for t in range(1, steps)]
    print(f"{'stage':16s} {'blocks':>6s} {'units':>5s} {'to_bar':>7s} "
          f"{'in_bar':>7s} {'work':>7s}", file=sys.stderr)
    for r in rows:
        print(f"{r['stage']:16s} {r['blocks_with_work']:6d} {r['units']:5d} "
              f"{r['to_barrier_us']:7.2f} {r['in_barrier_us']:7.2f} "
              f"{r['work_us']:7.2f}", file=sys.stderr)
    return {"step_us": float(np.median(step_us)),
            "sum_to_barrier_us": sum(r["to_barrier_us"] for r in rows),
            "sum_in_barrier_us": sum(r["in_barrier_us"] for r in rows),
            "stages": rows}


def main():
    from multimodalreactiongeneration_tpu_torch.configs import (
        LSTMFORMER_MODEL_CFG,
    )
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    tag = args[0] if args else os.getcwd()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    model = Metaformer(LSTMFORMER_MODEL_CFG,
                       generator=torch.Generator().manual_seed(0), device=dev)
    record = {"tag": tag, "rect_attention": attention(dev, rng)}
    if "--attention-only" not in sys.argv:
        record["decode_rollout"] = rollout(model, dev, rng)
        record["generate_metaformer_b16"] = generation(model, dev, rng)
    if "--stages" in sys.argv:
        record["decode_rollout_stages"] = stage_table(model, dev, rng)
    record["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
