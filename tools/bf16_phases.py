#!/usr/bin/env python3
"""The bf16-training phases of ``chip_smoke.py`` alone, on one CUDA card.

Run from the root of a checkout of the PyTorch port:

    python3 tools/bf16_phases.py

builds the two libraries the phases launch (``lstm_layer``,
``lstm_stacked``), then runs phase 29 (the bf16 modes of K7 and K9 against
their plain bf16 versions, timed beside the f32 kernels and cuDNN in bf16),
phase 12 (the f32 lws step, for the times beside), phase 30 (the bf16 lws
step) and phase 13d (the lws CLI with ``trainer.precision=bf16`` on a
corpus it writes under ``_build/cli_run`` and deletes). Each phase draws
from the generator ``chip_smoke.py`` gives it. The last line is one JSON
object: the bf16 kernels' records, the bf16 step's and the f32 step's.
"""
import json
import shutil
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")


def main():
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
    for name, seconds in _build.build_all(("lstm_layer",
                                           "lstm_stacked")).items():
        cs.log("build", kernel=name, seconds=f"{seconds:.1f}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = {"K1": K1, "K2": K2, "K5": K5, "K7": K7, "K8": K8, "K9": K9,
            "K10": K10}
    dev = torch.device("cuda", 0)
    k7, k9 = cs.bf16_kernel_phase(mods, dev,
                                  np.random.default_rng(cs.SEED + 29))
    f32 = cs.train_path_phase(mods, dev, np.random.default_rng(cs.SEED),
                              cs.lws_train_spec())
    step = cs.bf16_step_phase(mods, dev, np.random.default_rng(cs.SEED + 30))
    run = _build.BUILD_DIR / "cli_run"
    shutil.rmtree(run, ignore_errors=True)
    run.mkdir(parents=True)
    try:
        cs.write_corpus(str(run / "corpus"))
        cli = cs.cli_phase(mods, run, "configs/lstm_with_sampling.yaml",
                           "lws_bf16_cli", ["exp.batch_size=32",
                                            "trainer.precision=bf16"],
                           cs.lws_bf16_cli_launches)
    finally:
        shutil.rmtree(run)
    print(json.dumps({
        "kernels": cs.bf16_records(k7, k9, cli["launches"],
                                   train_step=step["launches"]),
        "lws_bf16_train_step": step["record"],
        "lws_train_step": f32["record"], "lws_bf16_cli": cli["record"],
        "seconds": time.perf_counter() - t0}))
    print(cs.card_line())


if __name__ == "__main__":
    main()
