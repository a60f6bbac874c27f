"""PyTorch port: ``Trainer.fit``, checkpoints and the generation eval vs
the JAX package, on the CPU.

A small Metaformer (hidden 32, 1 block, 2-block encoders) with the same
weights on both sides (``state_dict_from_jax``) trains for 2 epochs with
AdamW and the per-epoch cosine LR on the same batches (4 train, 2 valid,
one batch shape so JAX compiles each step once; B 2, T 24, lead 4),
``val_check_interval`` 0.5, no generation eval; the JAX side on a
one-device mesh. Held: per-epoch ``train_loss`` and ``val_loss`` to 1e-5
relative, the same ``metrics.jsonl`` record keys, the same top-k and
``last`` checkpoints; a run resumed from ``last`` gives the uninterrupted
run's next epoch (the optimizer state is restored); async and sync
checkpoints are byte-identical. ``make_generation_eval`` on one batch
matches JAX's to 1e-4 relative (6 free-running steps, the decode
tests' bound).
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.parallel.mesh import make_mesh
from multimodalreactiongeneration_tpu.train import harness as jharness
from multimodalreactiongeneration_tpu.train import optim as joptim
from multimodalreactiongeneration_tpu.train.generation_eval import (
    make_generation_eval as jax_generation_eval,
)
from multimodalreactiongeneration_tpu.utils.config import from_dict
from multimodalreactiongeneration_tpu_torch.models.lstmformer import Metaformer
from multimodalreactiongeneration_tpu_torch.train import checkpoint as ckpt
from multimodalreactiongeneration_tpu_torch.train import harness, optim
from multimodalreactiongeneration_tpu_torch.train.generation_eval import (
    make_generation_eval,
)
from tests.test_streaming_models import MF_CFG
from tests.test_torch_port_weights import np_batch, paired_models

torch.set_num_threads(1)

CFG = dict(MF_CFG, num_block=1, loss_type="huber", loss_reduction="mean",
           huber_delta=1.0, delta_loss_scale=1.0)
METRICS = dict(use_centroid=True, use_angle=True, delta_order=2)
OPTIM = dict(use_optimizer="adam", momentum=0.9, weight_decay=1e-2, lr=1e-3,
             use_lr_sched=True, batch_size=2, max_epochs=4)
CALLBACKS = dict(save_top_k=2, patience_epoch=10, use_checkpoint=True,
                 use_early_stopping=True, async_checkpoint=False,
                 save_opt_state="last")
EPOCHS, VCI = 2, 0.5


def _batches(seed, n):
    out = []
    for i in range(n):
        data = np_batch(seed + i, T=24, lead=4)
        data[6][0, -3:] = -100.0  # padded target frames
        lengths = [np.full(2, x.shape[1], np.int64) for x in data]
        lengths[6] = np.array([21, 24], np.int64)
        out.append(list(zip(data, lengths)))
    return out


TRAIN, VALID = _batches(100, 4), _batches(200, 2)


def _port_run(tmp, pm, epochs=EPOCHS, start_epoch=0, callbacks=CALLBACKS,
              opt_payload=None):
    opt = optim.build_optimizer(pm.parameters(), OPTIM)
    if opt_payload is not None:
        assert ckpt.restore_opt_state(opt_payload, opt)
    train_step, eval_step = harness.streaming_step_fns(
        pm, CFG, METRICS, opt, mask_self_motion_input=True)
    trainer = harness.Trainer(
        pm, train_step, eval_step, opt, OPTIM, callbacks_cfg=callbacks,
        log_dir=str(tmp / "log"), ckpt_dir=str(tmp / "ckpt"),
        val_check_interval=VCI, device="cpu")
    return trainer.fit(TRAIN, VALID, max_epochs=epochs,
                       start_epoch=start_epoch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm, params, pm = paired_models(CFG, 7, [x for x, _ in TRAIN[0]])
    state0 = {k: v.clone() for k, v in pm.state_dict().items()}

    jtmp = tmp_path_factory.mktemp("jax")
    jopt = joptim.build_optimizer(from_dict(OPTIM))
    jtrain, jeval = jharness.streaming_step_fns(
        jm, CFG, METRICS, jopt, mask_self_motion_input=True)
    jtrainer = jharness.Trainer(
        jm, jtrain, jeval, jopt, from_dict(OPTIM), callbacks_cfg=CALLBACKS,
        log_dir=str(jtmp / "log"), ckpt_dir=str(jtmp / "ckpt"),
        mesh=make_mesh(1), val_check_interval=VCI)
    with jax.default_matmul_precision("highest"):
        _, jres = jtrainer.fit(params, TRAIN, VALID, max_epochs=EPOCHS)

    def fresh():
        m = Metaformer(CFG, device="cpu")
        m.load_state_dict(state0)
        return m

    sync_tmp = tmp_path_factory.mktemp("sync")
    pres = _port_run(sync_tmp, fresh())
    async_tmp = tmp_path_factory.mktemp("async")
    _port_run(async_tmp, fresh(), callbacks=dict(CALLBACKS,
                                                 async_checkpoint=True))
    resume_tmp = tmp_path_factory.mktemp("resume")
    first = _port_run(resume_tmp, fresh(), epochs=1)
    payload = ckpt.load_checkpoint(str(resume_tmp / "ckpt" / "last"))
    resumed_model = fresh()
    resumed_model.load_state_dict(payload["params"])
    resumed = _port_run(resume_tmp, resumed_model,
                        start_epoch=payload["epoch"] + 1, opt_payload=payload)
    return dict(jax=(jtmp, jres), sync=(sync_tmp, pres),
                async_dir=async_tmp, first=first, resumed=resumed,
                payload=payload)


def test_fit_losses_match_jax(runs):
    (_, jres), (_, pres) = runs["jax"], runs["sync"]
    assert pres.epochs_run == jres.epochs_run == EPOCHS
    for got, want in zip(pres.history, jres.history):
        for key in ("train_loss", "val_loss", "lr"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=key)
        assert got["val_checks"] == want["val_checks"] == 2
        assert got["train_frames"] == want["train_frames"]
    np.testing.assert_allclose(pres.best_val_loss, jres.best_val_loss,
                               rtol=1e-5)


def _records(tmp):
    with open(tmp / "log" / "metrics.jsonl", encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def test_metrics_records_have_the_jax_keys(runs):
    jrec, prec = _records(runs["jax"][0]), _records(runs["sync"][0])
    assert len(prec) == len(jrec) == EPOCHS * 3  # 2 checks + 1 epoch record
    for got, want in zip(prec, jrec):
        assert list(got) == list(want)
        for key in ("val_loss", "train_loss", "train_loss_so_far"):
            if key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5)


def test_topk_and_last_checkpoints(runs, tmp_path):
    jdir, pdir = runs["jax"][0] / "ckpt", runs["sync"][0] / "ckpt"
    jnames, pnames = sorted(os.listdir(jdir)), sorted(os.listdir(pdir))
    assert len(pnames) == len(jnames) == 3  # top-2 on V, last
    assert "last" in pnames
    for got, want in zip(pnames, jnames):
        assert got.split("-")[0] == want.split("-")[0]
        if got != "last":
            np.testing.assert_allclose(float(got.split("-", 1)[1]),
                                       float(want.split("-", 1)[1]),
                                       atol=2e-6)
    last = ckpt.load_checkpoint(str(pdir / "last"))
    assert last["epoch"] == EPOCHS - 1 and "opt" in last
    top = ckpt.load_checkpoint(str(pdir / pnames[0]))
    assert "opt" not in top  # save_opt_state="last"
    # a new checkpointer seeds its top-k from the directory (a copy)
    pdir = tmp_path / "ckpt"
    shutil.copytree(runs["sync"][0] / "ckpt", pdir)
    again = ckpt.TopKCheckpointer(str(pdir), top_k=1, monitor="V")
    assert len([n for n in os.listdir(pdir) if n.startswith("V")]) == 1
    assert again.best_path() == str(pdir / min(
        (n for n in pnames if n.startswith("V")),
        key=lambda n: float(n.split("-", 1)[1])))


def test_resume_restores_optimizer_state(runs):
    (_, pres), first, resumed = runs["sync"], runs["first"], runs["resumed"]
    assert runs["payload"]["epoch"] == 0
    np.testing.assert_allclose(first.history[0]["train_loss"],
                               pres.history[0]["train_loss"], rtol=1e-6)
    assert [r["epoch"] for r in resumed.history] == [1]
    np.testing.assert_allclose(resumed.history[0]["train_loss"],
                               pres.history[1]["train_loss"], rtol=1e-6)
    np.testing.assert_allclose(resumed.history[0]["val_loss"],
                               pres.history[1]["val_loss"], rtol=1e-6)


def test_async_checkpoints_equal_sync(runs):
    sdir, adir = runs["sync"][0] / "ckpt", runs["async_dir"] / "ckpt"
    names = sorted(os.listdir(sdir))
    assert names == sorted(os.listdir(adir))
    for name in names:
        assert (sdir / name).read_bytes() == (adir / name).read_bytes(), name


def test_generation_eval_matches_jax():
    data = np_batch(300)  # T 6, lead 2
    jm, params, pm = paired_models(CFG, 8, data)
    batch = [(x, np.full(2, x.shape[1])) for x in data]
    want = jax_generation_eval(jm, "lstmformer", CFG)(params, [batch])
    got = make_generation_eval(pm, "lstmformer", CFG)([batch])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.isnan(make_generation_eval(pm, "lstmformer", CFG)([]))


def test_trainer_refuses_what_is_not_ported():
    """A 'model' mesh axis raises (parameter sharding, ROADMAP queue A,
    item 10); the data axis of the process group is taken
    (tests/test_torch_port_data_parallel.py), and so is scheduled
    sampling (tests/test_torch_port_train_options*.py)."""
    from multimodalreactiongeneration_tpu_torch.parallel import mesh

    pm = Metaformer(CFG, device="cpu")
    opt = optim.build_optimizer(pm.parameters(), OPTIM)
    with pytest.raises(NotImplementedError, match="item 10"):
        harness.Trainer(pm, None, None, opt, OPTIM,
                        mesh=mesh.make_mesh_2d(1, 2), device="cpu")
    assert harness.Trainer(pm, None, None, opt, OPTIM, mesh=mesh.make_mesh(),
                           device="cpu").mesh.shape == {"data": 1, "model": 1}
    trainer = harness.Trainer(pm, None, None, opt, OPTIM,
                              scheduled_max_epochs=3, device="cpu")
    assert trainer.scheduled_max_epochs == 3
    with pytest.raises(NotImplementedError, match="simple_lstm"):
        make_generation_eval(pm, "simple_lstm", CFG)
