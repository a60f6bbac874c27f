"""The readings behind the bounds of tests/test_torch_port_bf16_flagship.py
``test_bf16_flagship_step_matches_jax``, over model seeds.

For each seed, three bf16 SGD updates of a small Metaformer against JAX's
(``_step_readings``): the port's bf16 step, the port's f32 step (the
control) and JAX's own step from parameters moved by one f32 ulp, each
synced to JAX's parameters before every update (the test's reading) and
run on unsynced; with ``--remat`` or ``--accumulate 2`` as the test's other
cases. Run from the root of the repository (JAX on the CPU, the Pallas
calls in interpret mode, as the test runs them):

    JAX_PLATFORMS=cpu python tests/bf16_step_survey.py [--seeds 51 30 ...]

One JSON object per seed and mode, then one with the largest readings.
"""
import argparse
import functools
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[51, 30, 31, 40, 52, 53, 60, 61, 70, 71, 80, 81])
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--accumulate", type=int, default=1)
    a = ap.parse_args()
    os.environ["MRGEN_RNN_IMPL"] = "pallas"
    os.environ["MRGEN_FUSED_ATTN"] = "force"
    import torch
    from jax.experimental import pallas as pl

    pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    from tests import test_torch_port_bf16_flagship as t

    torch.set_num_threads(1)
    sides = [torch.bfloat16, torch.float32, "jax_moved"]
    worst = {}
    for seed in a.seeds:
        for sync in (True, False):
            read = t._step_readings(seed, a.remat, a.accumulate, sides,
                                    sync=sync)[0]
            row = {str(k): v for k, v in read.items()}
            print(json.dumps(dict(seed=seed, sync=sync, read=row)),
                  flush=True)
            for side, r in row.items():
                for key in ("move", "mean", "loss", "noise"):
                    value = r[key][0] if key in ("move", "mean") else r[key]
                    slot = (sync, side, key)
                    worst[slot] = max(worst.get(slot, 0.0), value)
    print(json.dumps({"largest": {f"{'synced' if s else 'unsynced'} {d} {k}":
                                  v for (s, d, k), v in worst.items()},
                      "seeds": a.seeds, "remat": a.remat,
                      "accumulate": a.accumulate}))


if __name__ == "__main__":
    main()
