"""Multi-session serving: a fixed pool of live dialogs advanced together.

Counterpart of ``multimodalreactiongeneration_tpu/infer/serving.py``.
A ``ServingEngine`` holds ``slots`` independent 12.5 fps sessions
(``StreamingSession`` semantics) and advances all of them with ONE
batched module call per 80 ms hop.

Design:
  * The pool is one decode state of batch ``slots``. JAX lifts a
    batch-1 step over the slots with ``vmap``, which gives every slot its
    own ring position; here each ring's ``length`` is a (slots,) tensor
    (``infer/cache.py``), so every row writes its own slot and masks its
    own unwritten slots, and sessions attached at different steps stay
    aligned to their own histories.
  * ``attach`` primes a batch-1 state on the session's leading segment
    (on the card the mixer-stack kernel, K1, runs over the lead's audio)
    and copies it into the pool at the slot's row, leaf by leaf: row 0
    of a ring's tensors to the slot's row, its int length to the
    slot's entry, and a recurrent state's (layers, 1, H) to column
    ``slot`` of the pooled (layers, slots, H).
  * Detached slots keep their rows and compute values nobody reads;
    their outputs come back as zeros (the fixed-capacity batching
    trade, as in JAX).
A step runs the plain recurrences (8 audio frames, 1 motion frame) and
the plain attention, as the JAX step does; no kernel runs per step.

Over a mesh (JAX's ``ServingEngine(mesh=...)``: the slot pool sharded
over 'data', the parameters replicated): ``mesh`` is a ``parallel/mesh.py
DataMesh`` of the process group, one process per card, each holding the
whole model. Rank k of the data axis holds the k-th contiguous block of
``slots / data`` rows (``shard_batch``'s block, JAX's ``P('data')``);
``slots % data`` must be 0, else ValueError, as in JAX. Every public call
is made on every rank with the same arguments (SPMD) and returns the same
result there: ``attach`` takes the same slot on every rank, and only the
slot's owner primes it (K1 runs once per attach, on the owner); ``detach``
frees it everywhere; ``step`` takes the whole (slots, hop) and (slots, 1,
D) inputs, each rank runs its rows (the fbank and one module call), and
the (slots, 1, D) outputs are gathered over the data axis; the states
never leave their card. One process per card, not one process driving
every card: the pool step is bound by the module step's launches
(PERF.md), and one host thread would issue every card's launches in
series. A mesh of one rank is the one-card pool.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from multimodalreactiongeneration_tpu_torch.infer.generate import (
    _init_metaformer_states,
    eval_mode,
)
from multimodalreactiongeneration_tpu_torch.infer.streaming import (
    _as_input,
    fbank_stream_geometry,
)
from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
    derived_sizes,
)
from multimodalreactiongeneration_tpu_torch.ops import dsp
from multimodalreactiongeneration_tpu_torch.parallel import distributed


def _is_ring(node) -> bool:
    return isinstance(node, dict) and "length" in node


def _pool(state, slots: int):
    """The batch-1 ``state`` repeated over ``slots`` rows."""
    if _is_ring(state):
        rows = {k: v.expand(slots, *v.shape[1:]).clone()
                for k, v in state.items() if k != "length"}
        device = next(iter(rows.values())).device
        rows["length"] = torch.full((slots,), state["length"],
                                    dtype=torch.long, device=device)
        return rows
    if isinstance(state, dict):
        return {k: _pool(v, slots) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_pool(v, slots) for v in state)
    if isinstance(state, torch.Tensor):  # (layers, 1, H) recurrent state
        return state.expand(state.shape[0], slots,
                            *state.shape[2:]).clone()
    return state


def _scatter(pooled, fresh, slot: int) -> None:
    """Copy the batch-1 ``fresh`` state into row ``slot`` of ``pooled``,
    in place."""
    if _is_ring(pooled):
        for k, v in pooled.items():
            v[slot] = fresh[k] if k == "length" else fresh[k][0]
    elif isinstance(pooled, dict):
        for k in pooled:
            _scatter(pooled[k], fresh[k], slot)
    elif isinstance(pooled, (list, tuple)):
        for p, f in zip(pooled, fresh):
            _scatter(p, f, slot)
    elif isinstance(pooled, torch.Tensor):
        pooled[:, slot] = fresh[:, 0]


class ServingEngine:
    """Fixed-capacity multi-session decode server for the Metaformer, on
    the device of the model's parameters.

    slots: sessions served at once. mesh: a ``parallel/mesh.py
    DataMesh`` whose data axis splits the pool (the module docstring), or
    None. cache_dtype: the rings' dtype, bf16 by default; int8 takes the
    per-block layout. kv_layout: "shared" unless the config or the dtype
    needs "per_block"."""

    def __init__(self, model, slots: int = 8, mesh=None, cache_dtype=None,
                 kv_layout: str = None):
        if slots < 1:
            raise ValueError(f"need at least 1 slot, got {slots}")
        parts = 1 if mesh is None else mesh.data
        if slots % parts:
            raise ValueError(f"{slots} slots do not divide over a data axis "
                             f"of {parts}")
        self.model = model
        self.cfg = model.cfg
        self.slots = slots
        self.mesh = mesh
        self.local_slots = slots // parts
        self._first = (0 if mesh is None
                       else mesh.data_rank * self.local_slots)
        self._group = None if mesh is None else mesh.group("data")
        self.device = next(model.parameters()).device
        self.cache_dtype = (
            torch.bfloat16 if cache_dtype is None else cache_dtype
        )
        if kv_layout is None:
            kv_layout = (
                "per_block"
                if self.cfg["repeat_with_encoder"]
                or self.cache_dtype == torch.int8
                else "shared"
            )
        self.kv_layout = kv_layout
        fbp, self.ratio, self.hop_samples, self.context_samples = (
            fbank_stream_geometry(self.cfg)
        )
        self._fbp = fbp
        self.feat_dim = derived_sizes(self.cfg)["motion_input_size"]
        self.active = np.zeros(slots, bool)
        self._free: List[int] = list(range(slots))[::-1]
        # this rank's rows: the fbank tails, the pooled states, the AR
        # loop's last frames
        local = self.local_slots
        self._tails = np.zeros((local, self.context_samples), np.float32)

        # the pool takes the structure a state settles into after one
        # call (recurrent embedding states materialize from None there)
        proto = self._fresh_state(np.zeros((1, self.ratio, fbp.feat_dim)),
                                  np.zeros((1, 1, self.feat_dim)),
                                  np.zeros((1, 1, self.feat_dim)))
        self._states = _pool(proto, local)
        self._prev = torch.zeros(local, 1, self.feat_dim, device=self.device)

    def owns(self, slot: int) -> bool:
        """Whether this rank holds ``slot``'s row (always, without a
        mesh)."""
        return self._first <= slot < self._first + self.local_slots

    @torch.no_grad()
    def _fresh_state(self, lead_audio, lead_mp, lead_ms):
        """A batch-1 state primed on a leading segment."""
        st = _init_metaformer_states(self.cfg, 1, self.cache_dtype,
                                     self.kv_layout, device=self.device)
        with eval_mode(self.model):
            _, st = self.model(
                _as_input(lead_audio, self.device),
                _as_input(lead_mp, self.device),
                _as_input(lead_ms, self.device),
                states=st, use_masks=True,
            )
        return st

    def attach(self, lead_audio, lead_mp, lead_ms) -> int:
        """Start a session on a leading segment (feature space: (1,
        L*ratio, F), (1, L, D), (1, L, D)): prime a fresh state, copy it
        into a free slot, seed the AR loop with the last lead self-motion
        frame. Returns the slot. Raises when the pool is full. Over a mesh
        only the slot's owner primes it."""
        if not self._free:
            raise RuntimeError(f"all {self.slots} slots are attached")
        slot = self._free.pop()
        if self.owns(slot):
            row = slot - self._first
            fresh = self._fresh_state(lead_audio, lead_mp, lead_ms)
            _scatter(self._states, fresh, row)
            self._prev[row] = _as_input(lead_ms, self.device)[0, -1:]
            self._tails[row] = 0.0
        self.active[slot] = True
        return slot

    def detach(self, slot: int) -> None:
        """End a session; the next ``attach`` reuses the slot."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not attached")
        self.active[slot] = False
        self._free.append(slot)

    @torch.no_grad()
    def step(self, audio_samples: np.ndarray,
             partner_motion: np.ndarray) -> np.ndarray:
        """Advance every session one frame with one batched module call.
        audio_samples (slots, hop_samples) raw f32, partner_motion (slots,
        1, D); rows of detached slots are ignored (pass zeros) and come
        back as zeros. Returns (slots, 1, D)."""
        if np.shape(audio_samples) != (self.slots, self.hop_samples):
            raise ValueError(
                f"need audio ({self.slots}, {self.hop_samples}), "
                f"got {np.shape(audio_samples)}"
            )
        if np.shape(partner_motion) != (self.slots, 1, self.feat_dim):
            raise ValueError(
                f"need partner_motion ({self.slots}, 1, {self.feat_dim}), "
                f"got {np.shape(partner_motion)}"
            )
        rows = slice(self._first, self._first + self.local_slots)
        buf = np.concatenate(
            [self._tails, np.asarray(audio_samples, np.float32)[rows]],
            axis=-1)
        self._tails = buf[:, -self.context_samples:]
        feat = dsp.logmel_with_power(_as_input(buf, self.device), self._fbp)
        with eval_mode(self.model):
            y, self._states = self.model(
                feat, _as_input(np.asarray(partner_motion)[rows],
                                self.device), self._prev,
                states=self._states, use_masks=False,
            )
        self._prev = y
        # an owned copy: on the CPU ``numpy()`` shares ``y``, the pool's
        # last frames, which a later attach writes into
        out = np.array(distributed.all_gather_rows(y, self._group).cpu())
        out[~self.active] = 0.0
        return out
