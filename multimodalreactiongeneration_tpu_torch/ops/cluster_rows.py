"""Rows per cluster of the LSTM chains K7 and K9 (``csrc/lstm_layer.cu``,
``csrc/lstm_stacked.cu``).

A chain runs one persistent 8-CTA cluster per R batch rows, R in
``ROWS``. A larger R holds more of the batch in the clusters the card
runs at once, at more shared memory per CTA and more work per step. The
wrappers pick R with ``choose_rows`` from what the card reports; a batch
of more clusters than the card holds runs in waves, each as long as the
whole chain.
"""

from __future__ import annotations

from typing import Mapping

ROWS = (16, 24, 32)
DEFAULT_ROWS = 16
SMEM_LIMIT = 232448  # shared memory a block can use on sm_90 (227 KB)


def choose_rows(batch: int, resident: Mapping[int, int],
                smem: Mapping[int, int]) -> int:
    """The smallest R of ``ROWS`` whose CTA fits ``SMEM_LIMIT`` bytes of
    shared memory (``smem[R]``) and whose ceil(batch / R) clusters the
    card holds at once (``resident[R]``, read only where the CTA fits);
    R 16, in waves, when none does. Raises if an R that fits reports no resident
    cluster: the card could not run the kernel at all."""
    if batch < 1:
        raise ValueError(f"batch {batch}")
    for rows in ROWS:
        if smem[rows] > SMEM_LIMIT:
            continue
        if resident[rows] < 1:
            raise ValueError(
                f"{rows} rows per cluster: the card holds {resident[rows]} "
                "clusters")
        if -(-batch // rows) <= resident[rows]:
            return rows
    return DEFAULT_ROWS


def card_layout(smem, resident):
    """(resident clusters, shared memory) by rows, as ``choose_rows``
    takes them, from ``smem(rows)`` and the card's ``resident(rows)``;
    the card is asked only where the CTA fits."""
    smem = {r: smem(r) for r in ROWS}
    return {r: resident(r) for r in ROWS if smem[r] <= SMEM_LIMIT}, smem


def resolve_rows(name: str, batch: int, rows, layout) -> int:
    """The rows per cluster of a launch of the kernel ``name``: ``rows``
    if the kernel takes it, else raise; None: ``choose_rows``. ``layout``
    is (resident clusters, shared memory) by rows, as ``choose_rows``
    takes them."""
    resident, smem = layout
    if rows is None:
        return choose_rows(batch, resident, smem)
    if rows not in ROWS:
        raise ValueError(
            f"{name}: no kernel for {rows} rows per cluster (takes {ROWS})")
    if smem[rows] > SMEM_LIMIT:
        raise ValueError(
            f"{name}: no kernel for {rows} rows per cluster here: a CTA "
            f"needs {smem[rows]} bytes of shared memory, more than "
            f"{SMEM_LIMIT}")
    return rows
