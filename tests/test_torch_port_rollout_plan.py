"""PyTorch port: the decode rollout's logits chunk, decided on the host.

``ops/decode_rollout.py logit_chunk`` is the one layout choice the
wrapper makes for ``csrc/decode_rollout.cu``: the ring slots per work
unit of the logits stage (S4), whose 16 dialogs x (audio + motion
chunks) units run on one block per SM. At the flagship's rings (1000
and 125 slots, 10 s of context) on an H100's 132 blocks it must take 144
slots, so that the stage's 128 units run in one round where 128-slot
chunks gave 144 units and a second round; in general the fewest rounds,
then the fewest slots, with at most 32 chunks a ring (one lane per chunk
merges the statistics); and it must raise for rings or grids the kernel
cannot take. No card is needed.
"""

import pytest

from multimodalreactiongeneration_tpu_torch.ops.decode_rollout import (
    BATCH_PER_LAUNCH,
    logit_chunk,
)

SA, SM, GRID = 1000, 125, 132  # the flagship's rings, an H100's SMs


def _chunks(ring, cs):
    return -(-ring // cs)


def _rounds(sa, sm, grid, cs):
    units = BATCH_PER_LAUNCH * (_chunks(sa, cs) + _chunks(sm, cs))
    return -(-units // grid)


def test_flagship_logits_stage_runs_in_one_round():
    cs = logit_chunk(SA, SM, GRID)
    assert cs == 144
    units = [(b, ring, c) for b in range(BATCH_PER_LAUNCH)
             for ring in (SA, SM) for c in range(_chunks(ring, cs))]
    assert len(units) == 128 <= GRID
    for ring in (SA, SM):  # each slot of each ring in exactly one unit
        slots = sorted(s for c in range(_chunks(ring, cs))
                       for s in range(c * cs, min(c * cs + cs, ring)))
        assert slots == list(range(ring))


def test_a_128_slot_chunk_would_take_two_rounds_at_the_flagship():
    assert _rounds(SA, SM, GRID, 128) == 2
    assert _rounds(SA, SM, GRID, 144) == 1


@pytest.mark.parametrize("sa,sm,grid", [
    (1000, 125, 132), (2048, 2048, 132), (96, 13, 132), (2000, 250, 114),
    (1000, 125, 16), (8, 8, 132), (1000, 125, 1),
])
def test_logit_chunk_takes_fewest_rounds_then_fewest_slots(sa, sm, grid):
    ok = [cs for cs in range(8, 2056, 8)
          if max(_chunks(sa, cs), _chunks(sm, cs)) <= 32]
    best = min(ok, key=lambda cs: (_rounds(sa, sm, grid, cs), cs))
    got = logit_chunk(sa, sm, grid)
    assert got == best and got % 8 == 0
    assert max(_chunks(sa, got), _chunks(sm, got)) <= 32


@pytest.mark.parametrize("sa,sm,grid", [
    (4096, 125, 132), (1000, 2049, 132), (0, 0, 132), (1000, 125, 0),
])
def test_logit_chunk_raises_for_rings_or_grids_the_kernel_cannot_take(
        sa, sm, grid):
    with pytest.raises(ValueError, match="rings of 1 to 2048"):
        logit_chunk(sa, sm, grid)
