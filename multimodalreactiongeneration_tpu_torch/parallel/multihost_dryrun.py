"""Real multi-process data-parallel dryrun: N ranks in one process group.

Counterpart of ``multimodalreactiongeneration_tpu/parallel/multihost_dryrun.py``.
The reference's DDP is multi-process by construction (Lightning spawns one
process per GPU and joins them over NCCL); so is the port's
(``parallel/distributed.py``). Here that path runs for real on one box:

  * ``launch_multihost(n)`` spawns n fresh python processes, joined in one
    ``torch.distributed`` process group through a file store in a fresh
    temporary directory (no port to pick), over gloo (CPU tensors, or
    CUDA tensors of one card: NCCL refuses two ranks on one GPU) or NCCL;
  * every rank builds the IDENTICAL model and global batches, keeps its
    rows through ``HostRowShard`` and stages them through
    ``Trainer._stage``; the ``Trainer`` wraps the model in DDP;
  * ``verify_multihost`` holds the ranks' train steps against one process
    (world size 1, no process group) on the same global batches: the
    global loss of every step, and the parameters after the steps
    (``step_readings`` reads them, ``check_steps`` holds them);
    ``verify_multihost_fit`` does the same for a 2-epoch ``Trainer.fit``
    (the validation history; rank 0 alone writes ``metrics.jsonl`` and
    the checkpoints).

The steps run SGD with momentum (JAX's dryrun runs Adam): the parameters
after a step are then linear in the averaged gradient, so a tolerance on
them reads the all-reduce; Adam's normalized update would turn rounding
noise in a near-zero gradient into a whole step.

``--variants`` runs the steps through each path a train step may take,
each from a fresh model in one launch: ``f32``, ``bf16`` (the bf16
copies through ``functional_call``), ``remat``, ``accumulate``
(``MultiSteps`` over 2 micro-steps) and ``scheduled`` (the
scheduled-sampling rollout, rate 0.5).

Run ``python -m multimodalreactiongeneration_tpu_torch.parallel.
multihost_dryrun --verify [--fit] [--device cuda] [--backend gloo]
[--hidden 256]`` for the comparison; the workers take ``--rank``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

# Tiny Metaformer with the flagship's config surface (JAX's dryrun model)
DRYRUN_MODEL_CFG = dict(
    main_modal_idx=2,
    hidden_size=64,
    num_block=2,
    dropout=0.0,
    num_layerd=1,
    encoder_num_layer=2,
    num_internal_layer=1,
    residual=True,
    residual_layer_norm=True,
    bias=True,
    emb_mixers=["lstm", "lstm", "lstm"],
    bottleneck_size=16,
    nonlinearity="none",
    ffn_nonlinearity="relu",
    proj_size=0,
    num_heads=4,
    add_bias_kv=False,
    add_zero_attn=False,
    max_context_len=10,
    repeat_with_encoder=False,
    interlayer_residual=False,
    interlayer_residual_norm=True,
    sampling_rate=16000,
    shift=160,
    pred_fps=12.5,
    modalities=["audio", "motion", "motion"],
    use_centroid=True,
    use_angle=True,
    nmels=26,
    delta_order=2,
    loss_type="huber",
    loss_reduction="mean",
    huber_delta=1.0,
    delta_loss_scale=1.0,
)
DRYRUN_METRICS_CFG = dict(use_centroid=True, use_angle=True, delta_order=2)
DRYRUN_OPTIM_DICT = dict(
    use_optimizer="sgd",
    momentum=0.9,
    weight_decay=1e-2,
    lr=1e-2,
    use_lr_sched=False,
)
RATIO = 8  # audio frames (100 Hz) per motion frame (12.5 fps)
GLOBAL_BATCH = 8
SEQ_T = 8
LEAD_T = 4
VARIANTS = ("f32", "bf16", "remat", "accumulate", "scheduled")


def global_batches(n: int, batch: int = GLOBAL_BATCH, t: int = SEQ_T,
                   lead: int = LEAD_T):
    """``n`` global 7-pair (data, lengths) batches, identical on every
    rank: one drawn from a fixed seed, shifted by 0.01 * i; the last two
    target frames of row 0 are -100 padding."""
    import numpy as np

    rng = np.random.default_rng(0)
    shapes = [(batch, t * RATIO, 81), (batch, t, 18), (batch, t, 18),
              (batch, lead * RATIO, 81), (batch, lead, 18), (batch, lead, 18),
              (batch, t, 18)]
    base = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    base[-1][0, -2:] = -100.0
    out = []
    for i in range(n):
        arrays = [x + np.float32(0.01 * i) if k < 6 else x.copy()
                  for k, x in enumerate(base)]
        if i:
            arrays[-1] = np.where(base[-1] == -100.0, base[-1],
                                  base[-1] + np.float32(0.01 * i))
        out.append([(x, np.full((batch,), x.shape[1], np.int32))
                    for x in arrays])
    return out


def _model_and_steps(device, hidden: int, variant: str):
    import torch

    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )
    from multimodalreactiongeneration_tpu_torch.train.harness import (
        scheduled_sampling_step_fn,
        streaming_step_fns,
    )
    from multimodalreactiongeneration_tpu_torch.train.optim import (
        build_optimizer,
    )

    cfg = dict(DRYRUN_MODEL_CFG, hidden_size=hidden)
    model = Metaformer(cfg, generator=torch.Generator().manual_seed(1),
                       device=device)
    optimizer = build_optimizer(
        model.parameters(), DRYRUN_OPTIM_DICT,
        accumulate_grad_batches=2 if variant == "accumulate" else 1)
    train_step, eval_step = streaming_step_fns(
        model, cfg, DRYRUN_METRICS_CFG, optimizer,
        mask_self_motion_input=True,
        compute_dtype=torch.bfloat16 if variant == "bf16" else torch.float32,
        remat=variant == "remat")
    if variant == "scheduled":
        sampled = scheduled_sampling_step_fn(
            model, "lstmformer", cfg, DRYRUN_METRICS_CFG, optimizer)

        def train_step(batch, generator=None):
            return sampled(batch, generator, 0.5)
    return model, optimizer, train_step, eval_step


def train_steps(device, hidden: int, variant: str, out_dir: str,
                steps: int = 2) -> Dict:
    """``steps`` train steps on this rank's rows of the global batches;
    returns the global losses and each step's ms (host clock, to the
    global loss on the host; the first step's includes the warm-up), and
    saves the parameters after them to ``out_dir/rank<r>_<variant>.pt``."""
    import time

    import torch

    from multimodalreactiongeneration_tpu_torch.data.dataset import (
        HostRowShard,
    )
    from multimodalreactiongeneration_tpu_torch.parallel import distributed
    from multimodalreactiongeneration_tpu_torch.train.harness import Trainer

    model, optimizer, train_step, eval_step = _model_and_steps(
        device, hidden, variant)
    rank, world = distributed.rank(), distributed.world_size()
    trainer = Trainer(model, train_step, eval_step, optimizer,
                      DRYRUN_OPTIM_DICT,
                      callbacks_cfg={"use_checkpoint": False},
                      log_dir=os.path.join(out_dir, f"log{rank}"),
                      device=device)
    generator = torch.Generator().manual_seed(3)
    losses, step_ms = [], []
    for local in HostRowShard(global_batches(steps), rank, world):
        t0 = time.perf_counter()
        loss, _ = train_step(trainer._stage(local), generator)
        losses.append(float(distributed.all_reduce_mean(loss.detach())))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(out_dir, f"rank{rank}_{variant}.pt"))
    return {"variant": variant, "losses": losses, "step_ms": step_ms,
            "ddp": distributed.data_parallel_of(model) is not None,
            "rows": int(local[0][0].shape[0])}


def fit_history(device, hidden: int, out_dir: str, epochs: int = 2,
                n_batches: int = 3) -> Dict:
    """A full ``Trainer.fit`` over this rank's rows of ``n_batches`` global
    batches (validation on the first): the per-epoch validation losses,
    the checkpoint files visible after it, and whether this rank wrote
    ``metrics.jsonl``."""
    from multimodalreactiongeneration_tpu_torch.data.dataset import (
        HostRowShard,
    )
    from multimodalreactiongeneration_tpu_torch.parallel import distributed
    from multimodalreactiongeneration_tpu_torch.train.harness import Trainer

    model, optimizer, train_step, eval_step = _model_and_steps(
        device, hidden, "f32")
    rank, world = distributed.rank(), distributed.world_size()
    log_dir = os.path.join(out_dir, f"log{rank}")
    ckpt_dir = os.path.join(out_dir, "ckpt")
    trainer = Trainer(model, train_step, eval_step, optimizer,
                      DRYRUN_OPTIM_DICT,
                      callbacks_cfg={"use_checkpoint": True, "save_top_k": 1},
                      log_dir=log_dir, ckpt_dir=ckpt_dir, device=device)
    batches = global_batches(n_batches)
    result = trainer.fit(HostRowShard(batches, rank, world),
                         HostRowShard(batches[:1], rank, world),
                         max_epochs=epochs)
    return {"rank": rank, "world": world,
            "vals": [h["val_loss"] for h in result.history],
            "frames": [h["train_frames"] for h in result.history],
            "trains": [h["train_loss"] for h in result.history],
            "ckpts": sorted(os.listdir(ckpt_dir))
            if os.path.isdir(ckpt_dir) else [],
            "wrote_metrics": os.path.exists(
                os.path.join(log_dir, "metrics.jsonl"))}


def run_worker(args) -> None:
    import torch

    from multimodalreactiongeneration_tpu_torch.parallel import distributed

    torch.set_num_threads(1)  # ranks share the host's cores
    if args.device == "cpu":
        torch.backends.cudnn.enabled = False
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    distributed.initialize_multihost(
        args.init_method, world_size=args.world, rank=args.rank,
        backend=args.backend, device=args.device)
    try:
        if args.mode == "fit":
            out = fit_history(args.device, args.hidden, args.out,
                              epochs=args.epochs)
        else:
            out = {"rank": distributed.rank(),
                   "steps": [train_steps(args.device, args.hidden, v,
                                         args.out)
                             for v in args.variants.split(",")]}
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print("MULTIHOST " + json.dumps(out), flush=True)


# --- launcher -------------------------------------------------------------

def launch_multihost(num_processes: int, out_dir: str, mode: str = "step",
                     variants: Sequence[str] = ("f32",), device: str = "cpu",
                     backend: Optional[str] = None, hidden: int = 64,
                     timeout: float = 300.0, group: bool = None,
                     epochs: int = 2) -> List[Dict]:
    """Run ``num_processes`` ranks (a process group where ``group``, by
    default when there are two or more) and return each rank's result,
    in rank order. Worker output goes to files, not pipes (a rank blocked
    on a full pipe would hold the others in a collective); every worker is
    waited on with ``timeout`` and killed if still running."""
    os.makedirs(out_dir, exist_ok=True)
    if group is None:
        group = num_processes > 1
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # ranks on one host
    store = tempfile.mkdtemp(prefix="mrgen_store_")
    cmd = [sys.executable, "-m",
           "multimodalreactiongeneration_tpu_torch.parallel.multihost_dryrun",
           "--world", str(num_processes), "--mode", mode, "--variants",
           ",".join(variants), "--device", device, "--hidden", str(hidden), "--out",
           out_dir, "--epochs", str(epochs)]
    if group:
        cmd += ["--init-method", f"file://{store}/store"]
    if backend:
        cmd += ["--backend", backend]
    procs = []
    try:
        for rank in range(num_processes):
            out_f = tempfile.TemporaryFile(mode="w+")
            err_f = tempfile.TemporaryFile(mode="w+")
            procs.append((subprocess.Popen(
                cmd + ["--rank", str(rank)], cwd=repo_root, env=env,
                stdout=out_f, stderr=err_f), out_f, err_f))
        outs = []
        for p, out_f, err_f in procs:
            p.wait(timeout=timeout)
            out_f.seek(0)
            err_f.seek(0)
            outs.append((p.returncode, out_f.read(), err_f.read()))
    finally:
        for p, out_f, err_f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out_f.close()
            err_f.close()
        for name in os.listdir(store):
            os.remove(os.path.join(store, name))
        os.rmdir(store)
    results = []
    for rc, out, err in outs:
        line = next((ln for ln in out.splitlines()
                     if ln.startswith("MULTIHOST ")), None)
        if rc != 0 or line is None:
            raise RuntimeError(
                f"dryrun worker failed (rc={rc}):\n{out}\n{err[-3000:]}")
        results.append(json.loads(line[len("MULTIHOST "):]))
    if [r["rank"] for r in results] != list(range(num_processes)):
        raise RuntimeError(f"expected ranks 0..{num_processes - 1}, got "
                           f"{[r['rank'] for r in results]}")
    return results


def _together(*launches):
    """The results of the launches, run at the same time (each waits on
    its own subprocesses)."""
    with ThreadPoolExecutor(len(launches)) as pool:
        return [f.result() for f in [pool.submit(fn) for fn in launches]]


def _params(path: str):
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def param_distance(a: Dict, b: Dict) -> float:
    """Largest ``max |a - b| / max(max |b|, 1)`` over the tensors."""
    return max(float((a[k].float() - b[k].float()).abs().max())
               / max(float(b[k].float().abs().max()), 1.0) for k in b)


def step_readings(num_processes: int = 2,
                  variants: Sequence[str] = VARIANTS, device: str = "cpu",
                  backend: Optional[str] = None, hidden: int = 64,
                  timeout: float = 300.0, timed: bool = False
                  ) -> Dict[str, Dict]:
    """The train steps of ``num_processes`` ranks in a process group (one
    rank too: a DDP group of one) and of one process without a group, on
    the same global batches, per variant: both sides' global losses and
    step times, whether each ran DDP, the rows each staged, and the
    distances ``check_steps`` holds. The two launches run at once, or
    with ``timed`` one after the other, so that neither side's step times
    contend with the other's."""
    with tempfile.TemporaryDirectory() as tmp:
        launches = (
            lambda: launch_multihost(1, os.path.join(tmp, "one"), "step",
                                     variants, device, backend, hidden,
                                     timeout, group=False)[0],
            lambda: launch_multihost(num_processes, os.path.join(tmp, "many"),
                                     "step", variants, device, backend,
                                     hidden, timeout, group=True))
        one, many = ([fn() for fn in launches] if timed
                     else _together(*launches))
        readings = {}
        for i, v in enumerate(variants):
            p_one = _params(os.path.join(tmp, "one", f"rank0_{v}.pt"))
            p_many = [_params(os.path.join(tmp, "many", f"rank{r}_{v}.pt"))
                      for r in range(num_processes)]
            single = one["steps"][i]
            ranks = [r["steps"][i] for r in many]
            readings[v] = {
                "single": single["losses"],
                "ranks": [r["losses"] for r in ranks],
                "single_step_ms": single["step_ms"],
                "rank_step_ms": [r["step_ms"] for r in ranks],
                "single_ddp": single["ddp"],
                "rank_ddp": [r["ddp"] for r in ranks],
                "rows": [single["rows"]] + [r["rows"] for r in ranks],
                "loss_err": max(abs(a - b) for r in ranks
                                for a, b in zip(r["losses"],
                                                single["losses"])),
                "rank_loss_err": max(abs(a - b) for r in ranks
                                     for a, b in zip(r["losses"],
                                                     ranks[0]["losses"])),
                "rank_param_err": max(param_distance(p, p_many[0])
                                      for p in p_many),
                "param_err": max(param_distance(p, p_one) for p in p_many)}
    return readings


def check_steps(r: Dict, loss_tol: float = 1e-4, param_tol: float = 1e-5,
                rank_tol: float = 1e-6) -> None:
    """One variant's ``step_readings``: the ranks ran DDP; every global
    loss within ``loss_tol`` of the single process's; the ranks' losses
    within ``rank_tol`` of each other and their parameters the same bits;
    each rank's parameters within ``param_tol`` (``param_distance``) of
    the single process's."""
    assert all(r["rank_ddp"]), r
    assert r["loss_err"] <= loss_tol, r
    assert r["rank_loss_err"] <= rank_tol and r["rank_param_err"] == 0.0, r
    assert r["param_err"] <= param_tol, r


def verify_multihost(num_processes: int = 2,
                     variants: Sequence[str] = VARIANTS, **kw) -> Dict:
    """``step_readings`` held by ``check_steps``; returns the readings."""
    readings = step_readings(num_processes, variants, **kw)
    for r in readings.values():
        check_steps(r)
    return readings


def verify_multihost_fit(num_processes: int = 2, device: str = "cpu",
                         backend: Optional[str] = None, hidden: int = 64,
                         timeout: float = 600.0, tol: float = 1e-4,
                         epochs: int = 2) -> Dict:
    """An ``epochs``-epoch ``Trainer.fit`` on ``num_processes`` ranks
    against one process: every rank's validation history within ``tol`` of
    the single process's, the same checkpoint files and trained frames
    (the global batch's), and ``metrics.jsonl`` from rank 0 alone. Returns
    the readings."""
    with tempfile.TemporaryDirectory() as tmp:
        one, many = _together(
            lambda: launch_multihost(1, os.path.join(tmp, "one"), "fit",
                                     device=device, backend=backend,
                                     hidden=hidden, timeout=timeout,
                                     epochs=epochs)[0],
            lambda: launch_multihost(num_processes, os.path.join(tmp, "many"),
                                     "fit", device=device, backend=backend,
                                     hidden=hidden, timeout=timeout,
                                     epochs=epochs))
    err = max(abs(a - b) for r in many for a, b in zip(r["vals"], one["vals"]))
    readings = {"single": one["vals"], "ranks": [r["vals"] for r in many],
                "val_err": err, "ckpts": [one["ckpts"]] +
                [r["ckpts"] for r in many],
                "frames": [one["frames"]] + [r["frames"] for r in many],
                "wrote_metrics": [r["wrote_metrics"] for r in many]}
    assert len(one["vals"]) == epochs and err <= tol, readings
    assert all(r["ckpts"] == one["ckpts"] for r in many), readings
    assert all(r["frames"] == one["frames"] for r in many), readings
    assert one["ckpts"] and readings["wrote_metrics"] == (
        [True] + [False] * (num_processes - 1)), readings
    return readings


def main(argv: Sequence[str]) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--mode", choices=["step", "fit"], default="step")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help=f"comma-separated, of {VARIANTS}")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=2, help="fit mode")
    ap.add_argument("--out", default=None)
    ap.add_argument("--verify", action="store_true",
                    help="launch the ranks and one process, and compare")
    ap.add_argument("--fit", action="store_true",
                    help="with --verify: the fit comparison")
    args = ap.parse_args(argv)
    if args.verify:
        fn = verify_multihost_fit if args.fit else verify_multihost
        kw = {} if args.fit else {"variants": args.variants.split(",")}
        print(json.dumps(fn(args.world, device=args.device,
                            backend=args.backend, hidden=args.hidden, **kw)))
        return
    run_worker(args)


if __name__ == "__main__":
    main(sys.argv[1:])
