#!/usr/bin/env python3
"""The live-serving phases of ``chip_smoke.py`` alone, and the hoisted
default decode's bits of a checkout, on one CUDA card.

Run from the root of a checkout of the PyTorch port:

    python3 <this file> phases [decode_layouts] [streaming] [serving]
        chip_smoke.py's phases 22-24 (all three unless named) after
        building the two libraries they launch; their record is the
        last line, one JSON object
    python3 <this file> bits OUT.npz
        the flagship (seed 0) generate_metaformer at B16 x 250 (lead 12)
        with the hoisted default path, teacher-forced and full masks,
        f32 and bf16 caches, each run twice (run-to-run bits kept);
        the checkout's own API only, so a parent's checkout runs it too
    python3 <this file> compare A.npz B.npz
        bit equality and max difference of two ``bits`` files
"""
import json
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")


def bits(out):
    from multimodalreactiongeneration_tpu_torch import _build
    from multimodalreactiongeneration_tpu_torch.configs import (
        LSTMFORMER_MODEL_CFG as cfg,
    )
    from multimodalreactiongeneration_tpu_torch.infer import generate as G
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )

    _build.build_all(("mixer_stack", "decode_rollout"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model = Metaformer(cfg, generator=torch.Generator().manual_seed(0),
                       device=dev)
    rng = np.random.default_rng(123)
    shapes = [(16, 2000, 81), (16, 250, 18), (16, 250, 18), (16, 96, 81),
              (16, 12, 18), (16, 12, 18), (16, 250, 18)]
    batch = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             .to(dev) for s in shapes]
    res = {}
    for mode in ("teacher", "full"):
        mask = G.sampling_mask_for(250, mode, device=dev)
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            a = G.generate_metaformer(model, batch, mask, cache_dtype=dt)
            b = G.generate_metaformer(model, batch, mask, cache_dtype=dt)
            res[f"{mode}_{name}"] = a.float().cpu().numpy()
            res[f"{mode}_{name}_rerun_equal"] = np.array(torch.equal(a, b))
    np.savez(out, **res)
    print("saved", out, list(res))


def compare(a, b):
    a, b = np.load(a), np.load(b)
    for k in a.files:
        if k.endswith("_equal"):
            print(k, bool(a[k]), bool(b[k]))
        else:
            print(k, "bit_equal", bool((a[k] == b[k]).all()),
                  "max_abs", float(np.abs(a[k] - b[k]).max()))


def phases():
    import chip_smoke as C
    from multimodalreactiongeneration_tpu_torch import _build
    from multimodalreactiongeneration_tpu_torch.configs import (
        LSTMFORMER_MODEL_CFG as cfg,
    )
    from multimodalreactiongeneration_tpu_torch.ops import (
        decode_rollout as K2, gru as K10, lstm_layer as K7,
        lstm_recurrence as K8, lstm_stacked as K9, mixer_stack as K1,
        rect_attention as K5,
    )

    print(C.card_line(), flush=True)
    _build.build_all(("mixer_stack", "decode_rollout"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = {"K1": K1, "K2": K2, "K5": K5, "K7": K7, "K8": K8, "K9": K9,
            "K10": K10}
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    rec = {}
    chosen = sys.argv[2:] or ["decode_layouts", "streaming", "serving"]
    for name in chosen:
        fn = getattr(C, name + "_phase")
        t = time.perf_counter()
        rec[name] = fn(mods, dev, cfg)
        rec[name + "_s"] = time.perf_counter() - t
        print(name, "seconds", rec[name + "_s"], flush=True)
    rec["seconds"] = time.perf_counter() - t0
    print(json.dumps(rec))


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "bits":
        bits(sys.argv[2])
    elif mode == "compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        phases()
