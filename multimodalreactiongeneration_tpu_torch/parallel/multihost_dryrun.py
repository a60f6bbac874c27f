"""Real multi-process dryrun: N ranks in one process group, on a mesh.

Counterpart of ``multimodalreactiongeneration_tpu/parallel/multihost_dryrun.py``.
The reference's DDP is multi-process by construction (Lightning spawns one
process per GPU and joins them over NCCL); so is the port's
(``parallel/distributed.py``). Here that path runs for real on one box:

  * ``launch_multihost(n, out_dir, jobs)`` spawns n fresh python
    processes, joined in one ``torch.distributed`` process group through a
    file store in a fresh temporary directory (no port to pick), over gloo
    (CPU tensors, or CUDA tensors of one card: NCCL refuses two ranks on
    one GPU) or NCCL; each runs the same list of jobs, in order, and
    returns one result per job;
  * a job lays the group out as a (data, model) mesh (``mesh``, by
    default every rank on the data axis); every rank builds the IDENTICAL
    model and global batches, keeps the rows of its place on the data
    axis through ``HostRowShard`` and stages them through
    ``Trainer._stage``; the ``Trainer`` wraps the model in DDP (a model
    axis of 1) or shards its parameters by JAX's ``param_sharding``;
  * ``step_readings`` holds the ranks' train steps against one process
    (world size 1, no process group) on the same global batches: the
    global loss of every step, the parameters after the steps (gathered
    whole on a model axis), the ranks' agreement, the elements each rank
    stores of the sharded parameters and of their optimizer state, and
    each rank's kernel launches (``check_steps`` holds them);
    ``verify_multihost_fit`` does the same for a ``Trainer.fit`` (the
    validation history; rank 0 alone writes ``metrics.jsonl`` and the
    checkpoints, which load ``strict=True`` into one process's model and
    equal the ranks' gathered parameters; a resume on the mesh);
    ``serving_request`` drives a ``ServingEngine`` whose slot pool is
    split over the data axis, with given weights, leads, inputs and
    attach / detach events, and returns each rank's outputs;
  * ``readings`` runs several of these requests in ONE launch of the
    ranks and one of the single process, so that process start-up is paid
    once.

The dryrun's steps run SGD with momentum (JAX's dryrun runs Adam): the
parameters after a step are then linear in the averaged gradient, so a
tolerance on them reads the all-reduce; Adam's normalized update would
turn rounding noise in a near-zero gradient into a whole step. The
``flagship`` scale (the flagship yaml's model at B32 x T240, lead 12)
takes the yaml's AdamW as ``chip_smoke.py`` phase 8 does; a mesh with no
data axis averages nothing, so its step is the single process's.

The variants run the steps through each path a train step may take, each
from a fresh model: ``f32``, ``bf16`` (the bf16 copies through
``functional_call``), ``remat``, ``accumulate`` (``MultiSteps`` over 2
micro-steps) and ``scheduled`` (the scheduled-sampling rollout, rate
0.5).

Run ``python -m multimodalreactiongeneration_tpu_torch.parallel.
multihost_dryrun --verify [--fit] [--mesh 1,2] [--world 2] [--device
cuda] [--backend gloo] [--hidden 256]`` for the comparison; the workers
take ``--rank`` and ``--jobs``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
# the flagship scale: chip_smoke.py phase 8's step
FLAGSHIP_BATCH, FLAGSHIP_T, FLAGSHIP_LEAD = 32, 240, 12
VARIANTS = ("f32", "bf16", "remat", "accumulate", "scheduled")
KERNEL_MODULES = ("mixer_stack", "decode_rollout", "lstm_layer",
                  "rect_attention", "lstm_stacked", "gru", "lstm_recurrence")


def global_batches(n: int, batch: int = GLOBAL_BATCH, t: int = SEQ_T,
                   lead: int = LEAD_T, seed: int = 0):
    """``n`` global 7-pair (data, lengths) batches, identical on every
    rank: one drawn from ``seed``, shifted by 0.01 * i; the last two
    target frames of row 0 are -100 padding."""
    import numpy as np

    rng = np.random.default_rng(seed)
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


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter, ``module.counter``."""
    out = {}
    for name in KERNEL_MODULES:
        mod = importlib.import_module(
            f"multimodalreactiongeneration_tpu_torch.ops.{name}")
        for attr, value in vars(mod).items():
            if attr.endswith("launches") and isinstance(value, int):
                out[f"{name}.{attr}"] = value
    return out


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    after = launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _scale(job) -> Tuple[Dict, Dict, Dict, Tuple[int, int, int]]:
    """(model cfg, metrics cfg, optim group, (batch, T, lead)) of a job's
    scale: the dryrun's tiny Metaformer (``hidden`` wide), the flagship
    yaml's at B32 x T240 with phase 8's AdamW, or the job's own ``cfg``,
    ``metrics`` and ``optim`` (its batch from ``batch_file``)."""
    if "cfg" in job:
        return job["cfg"], job["metrics"], job["optim"], None
    if job.get("scale", "dryrun") == "flagship":
        from multimodalreactiongeneration_tpu_torch import configs

        cfg = {**configs.LSTMFORMER_MODEL_CFG, **configs.LSTMFORMER_LOSS_CFG}
        optim = {**configs.LSTMFORMER_OPTIM_CFG, "lr": 1e-4,
                 "weight_decay": 1e-2, "use_lr_sched": False}
        return (cfg, dict(configs.LSTMFORMER_METRICS_CFG), optim,
                (FLAGSHIP_BATCH, FLAGSHIP_T, FLAGSHIP_LEAD))
    cfg = dict(DRYRUN_MODEL_CFG, hidden_size=job.get("hidden", 64))
    return (cfg, DRYRUN_METRICS_CFG, DRYRUN_OPTIM_DICT,
            (GLOBAL_BATCH, SEQ_T, LEAD_T))


def _mesh(job):
    """The job's mesh over the process group: ``mesh`` [data, model], or
    every rank on the data axis."""
    from multimodalreactiongeneration_tpu_torch.parallel.mesh import (
        make_mesh,
        make_mesh_2d,
    )

    shape = job.get("mesh")
    return make_mesh_2d(*shape) if shape else make_mesh()


def _model_and_steps(device, job):
    import torch

    from multimodalreactiongeneration_tpu_torch.models import build_model
    from multimodalreactiongeneration_tpu_torch.train.harness import (
        scheduled_sampling_step_fn,
        streaming_step_fns,
    )
    from multimodalreactiongeneration_tpu_torch.train.optim import (
        build_optimizer,
    )

    variant = job.get("variant", "f32")
    model_type = job.get("model_type", "lstmformer")
    cfg, metrics, optim, _ = _scale(job)
    model = build_model(model_type, cfg,
                        generator=torch.Generator().manual_seed(
                            1 + job.get("seed", 0)),
                        device=device)
    if job.get("weights"):
        model.load_state_dict(torch.load(job["weights"], map_location=device,
                                         weights_only=True))
    optimizer = build_optimizer(
        model.parameters(), optim,
        accumulate_grad_batches=2 if variant == "accumulate" else 1)
    train_step, eval_step = streaming_step_fns(
        model, cfg, metrics, optimizer,
        mask_self_motion_input=model_type == "lstmformer",
        compute_dtype=torch.bfloat16 if variant == "bf16" else torch.float32,
        remat=variant == "remat")
    if variant == "scheduled":
        sampled = scheduled_sampling_step_fn(
            model, model_type, cfg, metrics, optimizer)

        def train_step(batch, generator=None):
            return sampled(batch, generator, 0.5)
    return model, optimizer, train_step, eval_step, optim


def _save_whole(model, path: str) -> None:
    """The model's parameters, whole (gathered over a model axis), on the
    CPU."""
    import torch

    from multimodalreactiongeneration_tpu_torch.parallel import distributed

    with distributed.gathered(model):
        torch.save({k: v.detach().cpu() for k, v in
                    model.state_dict().items()}, path)


def _storage(model, optimizer) -> Dict[str, int]:
    """Elements this rank stores of the parameters ``param_sharding``
    splits and of their per-element optimizer state, beside the whole
    tensors' (ratio 1 where nothing is split)."""
    from multimodalreactiongeneration_tpu_torch.parallel import distributed
    from multimodalreactiongeneration_tpu_torch.train.optim import (
        map_param_state,
    )

    shards = distributed.param_shards(model)
    split = {} if shards is None else {id(p): p for p, _ in shards.split}
    whole = {k: math.prod(shards.whole_shape(p)) for k, p in split.items()}
    out = dict(stored=0, whole=0, state=0, state_whole=0)
    for key, p in split.items():
        out["stored"] += p.numel()
        out["whole"] += whole[key]

    def count(p, t):
        if id(p) in split and t.shape == p.shape:
            out["state"] += t.numel()
            out["state_whole"] += whole[id(p)]
        return t

    map_param_state(optimizer, count)
    return out


def train_steps(device, job, out_dir: str) -> Dict:
    """``job["steps"]`` train steps on this rank's rows of the global
    batches; returns the global losses, each step's ms (host clock, to the
    global loss on the host; the first step's includes the warm-up), the
    launches of the steps, whether the model ran DDP or sharded, the rows
    staged and the storage (``_storage``), and saves the parameters after
    them, whole, to ``out_dir/rank<r>_<tag>.pt``."""
    import torch

    from multimodalreactiongeneration_tpu_torch.data.dataset import (
        HostRowShard,
    )
    from multimodalreactiongeneration_tpu_torch.parallel import distributed
    from multimodalreactiongeneration_tpu_torch.train.harness import Trainer

    model, optimizer, train_step, eval_step, optim = _model_and_steps(
        device, job)
    mesh = _mesh(job)
    rank = distributed.rank()
    trainer = Trainer(model, train_step, eval_step, optimizer, optim,
                      callbacks_cfg={"use_checkpoint": False},
                      log_dir=os.path.join(out_dir, f"log{rank}"),
                      device=device, mesh=mesh)
    generator = torch.Generator().manual_seed(3)
    shape = _scale(job)[3]
    steps = job.get("steps", 2)
    if shape is None:  # the job's own batch, every step
        import numpy as np

        arrays = np.load(job["batch_file"])
        batch = [(arrays[f"a{i}"], np.full(arrays[f"a{i}"].shape[0],
                                           arrays[f"a{i}"].shape[1]))
                 for i in range(7)]
        batches = [batch] * steps
    else:
        batches = global_batches(steps, *shape, seed=job.get("seed", 0))
    losses, step_ms = [], []
    before = launch_counts()
    for local in HostRowShard(batches, mesh.data_rank, mesh.data):
        t0 = time.perf_counter()
        loss, _ = train_step(trainer._stage(local), generator)
        loss = distributed.axis_sum(loss.detach(), mesh.group("data"))
        losses.append(float(loss) / mesh.data)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _launches_since(before)
    _save_whole(model, os.path.join(out_dir, f"rank{rank}_{job['tag']}.pt"))
    return {"losses": losses, "step_ms": step_ms, "launches": launches,
            "ddp": distributed.data_parallel_of(model) is not None,
            "sharded": distributed.param_shards(model) is not None,
            "rows": int(local[0][0].shape[0]),
            "storage": _storage(model, optimizer)}


def fit_history(device, job, out_dir: str) -> Dict:
    """A full ``Trainer.fit`` of ``job["epochs"]`` epochs over this rank's
    rows of 3 global batches (validation on the first), checkpoints in
    ``out_dir/ckpt_<tag>``; with ``resume``, from the ``last`` of the
    job tagged ``resume`` (parameters and optimizer state loaded whole
    before the ``Trainer`` keeps this rank's slice). Returns the per-epoch
    validation losses, frames and train losses, the checkpoint files
    visible after it and whether this rank wrote ``metrics.jsonl``; saves
    the parameters after it, whole, to ``out_dir/rank<r>_<tag>.pt``."""
    from multimodalreactiongeneration_tpu_torch.data.dataset import (
        HostRowShard,
    )
    from multimodalreactiongeneration_tpu_torch.parallel import distributed
    from multimodalreactiongeneration_tpu_torch.train import checkpoint
    from multimodalreactiongeneration_tpu_torch.train.harness import Trainer

    model, optimizer, train_step, eval_step, optim = _model_and_steps(
        device, dict(job, variant="f32"))
    mesh = _mesh(job)
    rank = distributed.rank()
    log_dir = os.path.join(out_dir, f"log{rank}_{job['tag']}")
    ckpt_dir = os.path.join(out_dir, f"ckpt_{job['tag']}")
    start = 0
    if job.get("resume"):
        payload = checkpoint.load_checkpoint(os.path.join(
            out_dir, f"ckpt_{job['resume']}", "last"))
        model.load_state_dict(payload["params"])
        checkpoint.restore_opt_state(payload, optimizer)
        start = int(payload["epoch"]) + 1
    trainer = Trainer(model, train_step, eval_step, optimizer, optim,
                      callbacks_cfg={"use_checkpoint": True, "save_top_k": 1},
                      log_dir=log_dir, ckpt_dir=ckpt_dir, device=device,
                      mesh=mesh)
    batches = global_batches(3)
    result = trainer.fit(HostRowShard(batches, mesh.data_rank, mesh.data),
                         HostRowShard(batches[:1], mesh.data_rank, mesh.data),
                         max_epochs=start + job.get("epochs", 2),
                         start_epoch=start)
    _save_whole(model, os.path.join(out_dir, f"rank{rank}_{job['tag']}.pt"))
    return {"vals": [h["val_loss"] for h in result.history],
            "frames": [h["train_frames"] for h in result.history],
            "trains": [h["train_loss"] for h in result.history],
            "ckpt_dir": ckpt_dir,
            "ckpts": sorted(os.listdir(ckpt_dir))
            if os.path.isdir(ckpt_dir) else [],
            "wrote_metrics": os.path.exists(
                os.path.join(log_dir, "metrics.jsonl"))}


def serve(device, job, out_dir: str) -> Dict:
    """A ``ServingEngine`` of ``job["slots"]`` slots split over the job's
    mesh, on the Metaformer of ``job["cfg"]`` with the weights saved at
    ``job["weights"]``: at step t it applies the events ``[t, "attach",
    lead]`` / ``[t, "detach", slot]`` of ``job["events"]`` (leads and the
    per-step inputs from the ``.npz`` at ``job["inputs"]``), then steps.
    Saves the outputs (steps, slots, 1, D) to ``out_dir/serve_<tag>_
    rank<r>.npy``; returns each step's ms (host clock to the returned
    frames), the launches of the attaches and steps, the slot each attach
    took and how many of them this rank owns, and whether an engine of
    ``job["refuse_slots"]`` slots raised ValueError on this mesh."""
    import numpy as np
    import torch

    from multimodalreactiongeneration_tpu_torch.infer.serving import (
        ServingEngine,
    )
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )
    from multimodalreactiongeneration_tpu_torch.parallel import distributed

    model = Metaformer(job["cfg"], device=device)
    model.load_state_dict(torch.load(job["weights"], map_location=device,
                                     weights_only=True))
    mesh = _mesh(job)
    refused = None
    if job.get("refuse_slots"):
        try:
            ServingEngine(model, slots=job["refuse_slots"], mesh=mesh)
            refused = False
        except ValueError:
            refused = True
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[job["cache"]]
    engine = ServingEngine(model, slots=job["slots"], mesh=mesh,
                           cache_dtype=dtype)
    data = np.load(job["inputs"])
    events: Dict[int, List] = {}
    for t, what, arg in job["events"]:
        events.setdefault(t, []).append((what, arg))
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    outs, step_ms, taken = [], [], []
    before = launch_counts()
    for t in range(len(data["audio"])):
        for what, arg in events.get(t, ()):
            if what == "attach":
                taken.append(engine.attach(data["lead_audio"][arg],
                                           data["lead_mp"][arg],
                                           data["lead_ms"][arg]))
            else:
                engine.detach(arg)
        sync()
        t0 = time.perf_counter()
        outs.append(engine.step(data["audio"][t], data["mp"][t]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _launches_since(before)
    np.save(os.path.join(out_dir, f"serve_{job['tag']}_rank"
                         f"{distributed.rank()}.npy"), np.stack(outs))
    return {"step_ms": step_ms, "launches": launches, "slots_taken": taken,
            "owned": sum(engine.owns(s) for s in taken),
            "local_slots": engine.local_slots, "refused": refused}


JOBS = {"step": train_steps, "fit": fit_history, "serve": serve}


def _run_job(args, job) -> Dict:
    """One job; ``nccl_world_1``: inside a NCCL process group of this one
    process, made for the job and destroyed after it."""
    import torch

    from multimodalreactiongeneration_tpu_torch.parallel import distributed

    if not job.get("nccl_world_1"):
        return JOBS[job["kind"]](args.device, job, args.out)
    store = os.path.join(args.out, f"nccl_store_{job['tag']}")
    distributed.initialize_multihost(f"file://{store}", world_size=1, rank=0,
                                     backend="nccl", device=args.device)
    try:
        return JOBS[job["kind"]](args.device, job, args.out)
    finally:
        torch.distributed.destroy_process_group()


def run_worker(args) -> None:
    import torch

    from multimodalreactiongeneration_tpu_torch.parallel import distributed

    torch.set_num_threads(1)  # ranks share the host's cores
    if args.device == "cpu":
        torch.backends.cudnn.enabled = False
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with open(args.jobs, encoding="utf-8") as f:
        jobs = json.load(f)
    distributed.initialize_multihost(
        args.init_method, world_size=args.world, rank=args.rank,
        backend=args.backend, device=args.device)
    out = {"rank": distributed.rank(), "jobs": {}, "seconds": {}}
    try:
        for job in jobs:
            t0 = time.perf_counter()
            out["jobs"][job["tag"]] = _run_job(args, job)
            out["seconds"][job["tag"]] = time.perf_counter() - t0
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print("MULTIHOST " + json.dumps(out), flush=True)


# --- launcher -------------------------------------------------------------

def launch_multihost(num_processes: int, out_dir: str, jobs: Sequence[Dict],
                     device: str = "cpu", backend: Optional[str] = None,
                     timeout: float = 300.0, group: bool = None) -> List[Dict]:
    """Run ``num_processes`` ranks (a process group where ``group``, by
    default when there are two or more), each running ``jobs`` in order,
    and return each rank's results (``{"rank", "jobs": {tag: result}}``),
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
    jobs_path = os.path.join(out_dir, "jobs.json")
    with open(jobs_path, "w", encoding="utf-8") as f:
        json.dump(list(jobs), f)
    store = tempfile.mkdtemp(prefix="mrgen_store_")
    cmd = [sys.executable, "-m",
           "multimodalreactiongeneration_tpu_torch.parallel.multihost_dryrun",
           "--world", str(num_processes), "--jobs", jobs_path,
           "--device", device, "--out", out_dir]
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


# A request: (the single process's jobs, the ranks' jobs, and a function
# of (the single process's results by tag, each rank's results by tag,
# the launches' directories) that returns the readings).
Request = Tuple[List[Dict], List[Dict], Callable]


def readings(requests: Sequence[Request], num_processes: int = 2,
             device: str = "cpu", backend: Optional[str] = None,
             timeout: float = 300.0, timed: bool = False,
             seconds: Optional[List] = None) -> List:
    """Every request's readings, from ONE launch of ``num_processes``
    ranks running all the requests' rank jobs and one of a single process
    (no group) running their single-process jobs (each tag once). The two
    launches run at once, or with ``timed`` one after the other, so that
    neither side's step times contend with the other's. ``seconds``, a
    list, gets each request's job seconds (host clock, start-up and group
    set-up excluded): ``{"one": the single process's, "ranks": the
    slowest rank's}``."""
    single, seen = [], set()
    for jobs, _, _ in requests:
        for job in jobs:
            if job["tag"] not in seen:
                seen.add(job["tag"])
                single.append(job)
    ranks = [job for _, jobs, _ in requests for job in jobs]
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {"one": os.path.join(tmp, "one"),
                "many": os.path.join(tmp, "many")}
        launches = []
        if single:
            launches.append(lambda: launch_multihost(
                1, dirs["one"], single, device, backend, timeout,
                group=False))
        if ranks:
            launches.append(lambda: launch_multihost(
                num_processes, dirs["many"], ranks, device, backend, timeout,
                group=True))
        got = ([fn() for fn in launches] if timed
               else _together(*launches))
        one = got[0][0]["jobs"] if single else {}
        many = [r["jobs"] for r in got[-1]] if ranks else []
        if seconds is not None:
            took_one = got[0][0]["seconds"] if single else {}
            took = [r["seconds"] for r in got[-1]] if ranks else []
            seconds.extend(
                {"one": sum(took_one[j["tag"]] for j in jobs),
                 "ranks": max((sum(t[j["tag"]] for j in rjobs)
                               for t in took), default=0.0)}
                for jobs, rjobs, _ in requests)
        return [read(one, many, dirs) for _, _, read in requests]


def step_request(variants: Sequence[str] = VARIANTS,
                 mesh_shape: Optional[Sequence[int]] = None,
                 scale: str = "dryrun", hidden: int = 64, steps: int = 2,
                 tag: str = "steps", nccl_world_1: bool = False,
                 custom: Optional[Dict] = None, seed: int = 0) -> Request:
    """The train steps of each variant on the ranks (on ``mesh_shape``,
    by default every rank on the data axis) and in one process: per
    variant both sides' global losses and step times, whether each ran
    DDP or sharded, the rows each staged, the ranks' storage and
    launches, the distances ``check_steps`` holds, and rank 0's
    parameters after the steps, whole (``params``). ``nccl_world_1``:
    the ranks' side is instead one process in a NCCL group of its own,
    run in the single process's launch after its plain steps.
    ``custom``: the job's own model (``model_type``, ``cfg`` with the
    loss keys, ``metrics``, ``optim``, ``weights``: a saved state_dict)
    and batch (``batch_file``: an ``.npz`` of ``a0`` .. ``a6``, every
    step). ``seed`` draws the weights (``1 + seed``) and the global
    batches (``seed``)."""
    base = dict(kind="step", scale=scale, hidden=hidden, steps=steps,
                seed=seed, **(custom or {}))
    single = [dict(base, tag=f"{tag}_one_{v}", variant=v) for v in variants]
    ranks = [dict(base, tag=f"{tag}_{v}", variant=v,
                  mesh=list(mesh_shape) if mesh_shape else None,
                  nccl_world_1=nccl_world_1) for v in variants]
    if nccl_world_1:
        single, ranks = single + ranks, []

    def read(one, many, dirs):
        if nccl_world_1:
            many, dirs = [one], dict(dirs, many=dirs["one"])
        out = {}
        for v in variants:
            s, rs = one[f"{tag}_one_{v}"], [m[f"{tag}_{v}"] for m in many]
            p_one = _params(os.path.join(dirs["one"],
                                         f"rank0_{tag}_one_{v}.pt"))
            p_many = [_params(os.path.join(dirs["many"],
                                           f"rank{r}_{tag}_{v}.pt"))
                      for r in range(len(many))]
            model_axis = mesh_shape[1] if mesh_shape else 1
            out[v] = {
                "mesh": list(mesh_shape) if mesh_shape else [len(many), 1],
                "single": s["losses"], "ranks": [r["losses"] for r in rs],
                "single_step_ms": s["step_ms"],
                "rank_step_ms": [r["step_ms"] for r in rs],
                "single_ddp": s["ddp"], "rank_ddp": [r["ddp"] for r in rs],
                "rank_sharded": [r["sharded"] for r in rs],
                "model_axis": model_axis,
                "rows": [s["rows"]] + [r["rows"] for r in rs],
                "storage": [r["storage"] for r in rs],
                "single_launches": s["launches"],
                "rank_launches": [r["launches"] for r in rs],
                "loss_err": max(abs(a - b) for r in rs
                                for a, b in zip(r["losses"], s["losses"])),
                "loss_rel_err": max(abs(a - b) / abs(b) for r in rs
                                    for a, b in zip(r["losses"],
                                                    s["losses"])),
                "rank_loss_err": max(abs(a - b) for r in rs
                                     for a, b in zip(r["losses"],
                                                     rs[0]["losses"])),
                "rank_param_err": max(param_distance(p, p_many[0])
                                      for p in p_many),
                "param_err": max(param_distance(p, p_one) for p in p_many),
                "params": p_many[0]}
        return out

    return single, ranks, read


def step_readings(num_processes: int = 2,
                  variants: Sequence[str] = VARIANTS, device: str = "cpu",
                  backend: Optional[str] = None, hidden: int = 64,
                  timeout: float = 300.0, timed: bool = False,
                  mesh_shape: Optional[Sequence[int]] = None,
                  scale: str = "dryrun", steps: int = 2) -> Dict[str, Dict]:
    """``step_request``'s readings in their own launches."""
    return readings([step_request(variants, mesh_shape, scale, hidden,
                                  steps)], num_processes, device, backend,
                    timeout, timed)[0]


def check_steps(r: Dict, loss_tol: float = 1e-4, param_tol: float = 1e-5,
                rank_tol: float = 1e-6, loss_rel_tol: float = None) -> None:
    """One variant's ``step_readings``: the ranks ran DDP (a model axis of
    1) or sharded, each storing 1/model of the sharded parameters and of
    their optimizer state; every global loss within ``loss_tol`` (and
    ``loss_rel_tol`` relative, where given) of the single process's; the
    ranks' losses within ``rank_tol`` of each other and their parameters
    the same bits; each rank's parameters within ``param_tol``
    (``param_distance``) of the single process's."""
    m = r["model_axis"]
    if m == 1:
        assert all(r["rank_ddp"]) and not any(r["rank_sharded"]), r
    else:
        assert all(r["rank_sharded"]) and not any(r["rank_ddp"]), r
        for s in r["storage"]:
            assert s["whole"] > 0 and s["stored"] * m == s["whole"], r
            assert s["state"] * m == s["state_whole"] > 0, r
    assert r["loss_err"] <= loss_tol, r
    if loss_rel_tol is not None:
        assert r["loss_rel_err"] <= loss_rel_tol, r
    assert r["rank_loss_err"] <= rank_tol and r["rank_param_err"] == 0.0, r
    assert r["param_err"] <= param_tol, r


def verify_multihost(num_processes: int = 2,
                     variants: Sequence[str] = VARIANTS, **kw) -> Dict:
    """``step_readings`` held by ``check_steps``; returns the readings."""
    result = step_readings(num_processes, variants, **kw)
    for r in result.values():
        check_steps(r)
    return result


def fit_request(epochs: int = 2, mesh_shape: Optional[Sequence[int]] = None,
                hidden: int = 64, tag: str = "fit", tol: float = 1e-4,
                resume: bool = False) -> Request:
    """An ``epochs``-epoch ``Trainer.fit`` on the ranks (on
    ``mesh_shape``) against one process: every rank's validation history
    within ``tol`` of the single process's, the same checkpoint files
    (``_same_ckpts``) and trained frames (the global batch's),
    ``metrics.jsonl`` from rank 0 alone, and the ranks' ``last``
    checkpoint loaded ``strict=True`` into one process's model equal to
    the ranks' gathered parameters. With
    ``resume`` each side then resumes from its ``last`` for one more
    epoch, held the same way."""
    base = dict(kind="fit", hidden=hidden, epochs=epochs)
    # the single process's fit is the same for every mesh: one run serves
    # every request of the launch
    one_tag = f"fit_one_h{hidden}_e{epochs}"
    single = [dict(base, tag=one_tag)]
    ranks = [dict(base, tag=tag, mesh=list(mesh_shape) if mesh_shape
                  else None)]
    if resume:
        single.append(dict(base, tag=f"{one_tag}_resumed", epochs=1,
                           resume=one_tag))
        ranks.append(dict(ranks[0], tag=f"{tag}_resumed", epochs=1,
                          resume=tag))

    def check(one, many, dirs, t_one, t_many, n_epochs):
        s, rs = one[t_one], [m[t_many] for m in many]
        err = max(abs(a - b) for r in rs for a, b in zip(r["vals"],
                                                         s["vals"]))
        out = {"single": s["vals"], "ranks": [r["vals"] for r in rs],
               "val_err": err, "ckpts": [s["ckpts"]] + [r["ckpts"]
                                                        for r in rs],
               "frames": [s["frames"]] + [r["frames"] for r in rs],
               "wrote_metrics": [r["wrote_metrics"] for r in rs]}
        out["ckpt_strict_err"] = _strict_load_err(
            os.path.join(rs[0]["ckpt_dir"], "last"),
            [os.path.join(dirs["many"], f"rank{r}_{t_many}.pt")
             for r in range(len(rs))], hidden)
        assert len(s["vals"]) == n_epochs and err <= tol, out
        assert all(_same_ckpts(r["ckpts"], s["ckpts"]) for r in rs), out
        assert all(r["frames"] == s["frames"] for r in rs), out
        assert s["ckpts"] and out["wrote_metrics"] == (
            [True] + [False] * (len(rs) - 1)), out
        assert out["ckpt_strict_err"] == 0.0, out
        return out

    def read(one, many, dirs):
        out = check(one, many, dirs, one_tag, tag, epochs)
        if resume:
            out["resumed"] = check(one, many, dirs, f"{one_tag}_resumed",
                                   f"{tag}_resumed", 1)
        return out

    return single, ranks, read


def _same_ckpts(a: Sequence[str], b: Sequence[str]) -> bool:
    """The same checkpoint files, the losses their names carry (``V0-
    0.448533``) equal or one unit apart in the sixth decimal: two losses
    a few ulps apart may round either side of it. The losses themselves
    are held to ``tol`` beside this."""
    def split(names):
        return [(n.split("-", 1) + [None])[:2] for n in sorted(names)]

    return len(a) == len(b) and all(
        x[0] == y[0] and (x[1] == y[1] or abs(float(x[1]) - float(y[1]))
                          < 1.5e-6)
        for x, y in zip(split(a), split(b)))


def _strict_load_err(ckpt: str, gathered: Sequence[str], hidden: int) -> float:
    """The ``last`` checkpoint loaded ``strict=True`` into one process's
    dryrun model: its largest distance from each rank's gathered
    parameters."""
    import torch

    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )
    from multimodalreactiongeneration_tpu_torch.train.checkpoint import (
        load_checkpoint,
    )

    model = Metaformer(dict(DRYRUN_MODEL_CFG, hidden_size=hidden),
                       device="cpu")
    model.load_state_dict(load_checkpoint(ckpt)["params"], strict=True)
    loaded = {k: v.detach() for k, v in model.state_dict().items()}
    return max(param_distance(loaded, _params(p)) for p in gathered)


def verify_multihost_fit(num_processes: int = 2, device: str = "cpu",
                         backend: Optional[str] = None, hidden: int = 64,
                         timeout: float = 600.0, tol: float = 1e-4,
                         epochs: int = 2,
                         mesh_shape: Optional[Sequence[int]] = None,
                         resume: bool = False) -> Dict:
    """``fit_request``'s readings in their own launches; returns them."""
    return readings([fit_request(epochs, mesh_shape, hidden, tol=tol,
                                 resume=resume)], num_processes, device,
                    backend, timeout)[0]


def serving_request(cfg: Dict, weights: str, inputs: str,
                    events: Sequence, slots: int, cache: str = "f32",
                    mesh_shape: Optional[Sequence[int]] = None,
                    refuse_slots: Optional[int] = None,
                    tag: str = "serve") -> Request:
    """A ``ServingEngine`` of ``slots`` slots split over the ranks' mesh
    (``serve``'s job); the readings: each rank's outputs (steps, slots, 1,
    D), step ms, launches, the slots the attaches took and how many each
    rank owns, and whether ``refuse_slots`` slots raised. No single
    process runs it: the caller holds it to its own engine."""
    job = dict(kind="serve", tag=tag, cfg=cfg, weights=weights,
               inputs=inputs, events=[list(e) for e in events], slots=slots,
               cache=cache, mesh=list(mesh_shape) if mesh_shape else None,
               refuse_slots=refuse_slots)

    def read(one, many, dirs):
        import numpy as np

        rs = [m[tag] for m in many]
        return {"outputs": [np.load(os.path.join(
                    dirs["many"], f"serve_{tag}_rank{r}.npy"))
                    for r in range(len(rs))],
                **{k: [r[k] for r in rs] for k in (
                    "step_ms", "launches", "slots_taken", "owned",
                    "local_slots", "refused")}}

    return [], [job], read


def main(argv: Sequence[str]) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--jobs", default=None, help="worker: the jobs' JSON")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help=f"comma-separated, of {VARIANTS}")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--mesh", default=None,
                    help="data,model (default: every rank on 'data')")
    ap.add_argument("--out", default=None)
    ap.add_argument("--verify", action="store_true",
                    help="launch the ranks and one process, and compare")
    ap.add_argument("--fit", action="store_true",
                    help="with --verify: the fit comparison")
    args = ap.parse_args(argv)
    if args.verify:
        mesh = [int(x) for x in args.mesh.split(",")] if args.mesh else None
        kw = dict(device=args.device, backend=args.backend,
                  hidden=args.hidden, mesh_shape=mesh)
        if args.fit:
            print(json.dumps(verify_multihost_fit(args.world, **kw)))
        else:
            print(json.dumps(verify_multihost(
                args.world, args.variants.split(","), **kw)))
        return
    run_worker(args)


if __name__ == "__main__":
    main(sys.argv[1:])
