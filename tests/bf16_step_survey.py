"""The readings behind the bounds of the bf16 step tests, over model seeds.

``--model flagship`` (the default): tests/test_torch_port_bf16_flagship.py
``test_bf16_flagship_step_matches_jax``; ``gru``: the GRU Metaformer of
tests/test_torch_port_bf16_gru.py ``test_bf16_gru_step_matches_jax``;
``flagship_k8``: the flagship under ``MRGEN_FUSED_DW=0`` (its self-motion
LSTMs on K8's route) of ``test_bf16_flagship_k8_step_matches_jax``. For
each seed, three bf16 SGD updates of a small Metaformer against JAX's
(``_step_readings``): the port's bf16 step, the port's f32 step (the
control) and JAX's own step from parameters moved by one f32 ulp, each
synced to JAX's parameters before every update (the tests' reading) and
run on unsynced; with ``--remat`` or ``--accumulate 2`` as the tests'
other cases. ``lws_k8``: lstm_with_sampling under ``MRGEN_FUSED_DW=0``
(tests/test_torch_port_bf16_train.py
``test_bf16_train_step_on_k8_route_matches_jax``), the same readings.
``scan_routes``: the readings behind the bound of
tests/test_torch_port_bf16_recurrence.py on the routes under 16 steps,
a 2-layer 24 -> 32 ``TorchGRU`` and ``TorchLSTM`` over 7 steps in bf16
against JAX's (``_module_pair``): each output's and the parameter
gradients' largest error over the largest magnitude. Run from the root
of the repository (JAX on the CPU, the Pallas
calls in interpret mode, as the tests run them):

    JAX_PLATFORMS=cpu python tests/bf16_step_survey.py [--model gru] \\
        [--seeds 51 30 ...]

One JSON object per seed and mode, then one with the largest readings.
"""
import argparse
import functools
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

MODELS = ("flagship", "gru", "flagship_k8", "lws_k8", "scan_routes")


def scan_routes(seeds):
    """One JSON line per module kind and seed (``scan_routes``)."""
    import numpy as np
    import torch

    from multimodalreactiongeneration_tpu.nn.recurrent import (
        TorchGRU as JaxGRU,
        TorchLSTM as JaxLSTM,
    )
    from multimodalreactiongeneration_tpu_torch.models.weights import (
        state_dict_from_jax,
    )
    from multimodalreactiongeneration_tpu_torch.nn import recurrent
    from tests import test_torch_port_bf16_recurrence as tr

    import jax.numpy as jnp

    def rel(got, want):
        g, w = got.detach().float().numpy(), tr._np(want)
        return float(np.abs(g - w).max() / np.abs(w).max())

    for kind, jcls, pcls in (("gru", JaxGRU, recurrent.TorchGRU),
                             ("lstm", JaxLSTM, recurrent.TorchLSTM)):
        for seed in seeds:
            x = np.random.default_rng(seed).standard_normal(
                (2, 7, 24)).astype(np.float32)
            jm = jcls(input_size=24, hidden_size=32, num_layers=2,
                      impl="pallas")
            pm = pcls(24, 32, torch.Generator().manual_seed(0),
                      num_layers=2)
            want, jgrads, got, pgrads = tr._module_pair(
                jm, pm, x, jnp.bfloat16, seed)
            sd = state_dict_from_jax(jgrads)
            print(json.dumps(dict(
                model=kind, seed=seed,
                outputs=[rel(g, w) for g, w in zip(got, want)],
                gradients=max(rel(g, sd[n]) for n, g in pgrads.items()))),
                flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=MODELS, default="flagship")
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[51, 30, 31, 40, 52, 53, 60, 61, 70, 71, 80, 81])
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--accumulate", type=int, default=1)
    a = ap.parse_args()
    os.environ["MRGEN_RNN_IMPL"] = "pallas"
    os.environ["MRGEN_FUSED_ATTN"] = "force"
    if a.model.endswith("_k8"):
        os.environ["MRGEN_FUSED_DW"] = "0"
    import torch
    from jax.experimental import pallas as pl

    pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    from tests import test_torch_port_bf16_flagship as t
    from tests import test_torch_port_bf16_gru as tg
    from tests import test_torch_port_bf16_train as tl

    torch.set_num_threads(1)
    if a.model == "scan_routes":
        return scan_routes(a.seeds)
    model = dict(cfg=tg.GRU_CFG) if a.model == "gru" else dict(cfg=t.CFG)
    if a.model == "lws_k8":
        model = dict(cfg=tl.CFG, pair=tl._pair, make_batch=tl._batch,
                     mask=False)
    sides = [torch.bfloat16, torch.float32, "jax_moved"]
    worst = {}

    def keep(sync, row):
        for side, r in row.items():
            for key, value in r.items():
                value = value[0] if isinstance(value, tuple) else value
                slot = (sync, side, key)
                worst[slot] = max(worst.get(slot, 0.0), value)

    for seed in a.seeds:
        for sync in (True, False):
            read = t._step_readings(seed, a.remat, a.accumulate, sides,
                                    sync=sync, **model)[0]
            row = {str(k): v for k, v in read.items()}
            print(json.dumps(dict(seed=seed, sync=sync, read=row)),
                  flush=True)
            keep(sync, row)
    print(json.dumps({"largest": {f"{'synced' if s else 'unsynced'} {d} {k}":
                                  v for (s, d, k), v in worst.items()},
                      "model": a.model, "seeds": a.seeds, "remat": a.remat,
                      "accumulate": a.accumulate}))


if __name__ == "__main__":
    main()
