#!/usr/bin/env python3
"""Phases 40 and 41 of ``chip_smoke.py`` alone, on one CUDA card: the
head counts and hidden sizes up to 256 on K5/K6, K8, K10 and K9's layer
route (40), the encoder stack K1/K3/K4 at every hidden size to 512 and
the LSTM layer K7 at 384 and 512 (41).

Run from the root of a checkout of the PyTorch port:

    python3 tools/shape_phases.py [kernels] [models] [stack_kernels]
        [stack_models]

builds the eight libraries at once (printing the register and spill
lines of each from nvcc's ``-Xptxas -v`` log), then runs, each part as
``chip_smoke.py`` runs it (the default: all four): with ``kernels`` phase
40a (each new shape against its plain version, timed beside SDPA or
cuDNN); with ``models`` phases 40b and 40c (the GRU Metaformer at hidden
192 and 4 heads, lstm_with_sampling at hidden 192 and sampler 192, the
flagship at 2 and 1 heads: f32 and bf16 steps, card against CPU,
generations); with ``stack_kernels`` phase 41a (K1/K3/K4 at H 100, 192,
384 and 512, K7 at 384 and 512, f32 and bf16, against their plain
versions); with ``stack_models`` phases 41b to 41d (the flagship at
hidden 192 and 512: f32 and bf16 steps, card against CPU; a generation
at 192; the forward on bf16 parameters at 192 and 512). Each phase's parts draw from their own generators (``SEED +
40``, ``SEED + 41``), as in ``chip_smoke.py``. The last line is one JSON
object: the kernel cases, the model runs' records and launches, and
(where a phase ran both parts) the kernels' records.
"""
import json
import sys
import time

import torch

sys.path.insert(0, ".")


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
        raise RuntimeError("shape_phases: no CUDA device; nothing was run")
    t0 = time.perf_counter()
    for name, seconds in _build.build_all(cs.LIBS).items():
        cs.log("build", kernel=name, seconds=f"{seconds:.1f}")
        for line in (_build.BUILD_DIR / f"{name}.log").read_text(
                ).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("   ", line.strip())
    cs.log("build", total_seconds=f"{time.perf_counter() - t0:.1f}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = {"K1": K1, "K2": K2, "K5": K5, "K7": K7, "K8": K8, "K9": K9,
            "K10": K10}
    dev = torch.device("cuda", 0)
    out = {"card": cs.card_line()}
    for phase, run, to_records, k, m in (
            (40, cs.shape_phases, cs.shape_records, "kernels", "models"),
            (41, cs.stack_shape_phases, cs.stack_shape_records,
             "stack_kernels", "stack_models")):
        if k not in parts and m not in parts:
            continue
        kernels, launches, records = run(mods, dev, k in parts, m in parts)
        out[phase] = {"kernels": kernels, "models": records,
                      "launches": launches}
        if kernels and records:
            out[phase]["records"] = to_records(kernels, launches)
    cs.log("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["kernels", "models", "stack_kernels",
                                   "stack_models"]))
