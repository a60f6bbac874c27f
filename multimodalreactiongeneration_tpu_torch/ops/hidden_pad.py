"""Zero padding of a recurrence's hidden size up to the size a kernel is
built for.

The recurrence kernels K8 (``ops/lstm_recurrence.py``), K9's layer route
(``ops/lstm_stacked.py``) and K10 (``ops/gru.py``) are built for hidden
sizes 64, 128, 192 and 256 (``HIDDEN_SIZES``), as JAX's kernels take any
hidden size. Any other H up to 256 runs on the next of them,
``padded_hidden(H)``: each gate block of the gate-major arrays (xw, the
weights' columns, b_hh) and the weights' rows, h0 and c0 get zero units
after the real ones, and the outputs' padded units are dropped. That is
exact in both operand modes: a padded unit's gates read 0 from xw and
from W_hh, so an LSTM's c and h stay 0 (g = tanh(0) = 0 and c0 = 0) and
a GRU's h stays 0 (n = tanh(0) = 0, so h' = z 0); the padded rows of
W_hh meet only those zeros, and in the backward every padded dgate is 0.
The functions are differentiable, so autograd gives the real units'
gradients of the padded arrays' back.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

HIDDEN_SIZES = (64, 128, 192, 256)  # the sizes the kernels are built for


def padded_hidden(h: int) -> Optional[int]:
    """The least of ``HIDDEN_SIZES`` that is at least ``h``, or None above
    256 (or below 1)."""
    if h < 1:
        return None
    return next((s for s in HIDDEN_SIZES if s >= h), None)


def unbuilt(hidden: int, kernel: str, entry: str) -> Optional[str]:
    """Why the kernels themselves cannot take this hidden size up to 256
    (they are built for ``HIDDEN_SIZES``; ``entry`` pads it), or None."""
    if hidden in HIDDEN_SIZES or padded_hidden(hidden) is None:
        return None
    return (f"hidden size {hidden}: the {kernel} kernels are built for "
            f"{HIDDEN_SIZES}; {entry} pads it to {padded_hidden(hidden)}")


def pad_gates(x: torch.Tensor, gates: int, hp: int) -> torch.Tensor:
    """x's last dim, ``gates`` blocks of H units, as blocks of ``hp``: each
    block's units followed by hp - H zeros (x itself when H is hp)."""
    h = x.shape[-1] // gates
    if h == hp:
        return x
    blocks = x.reshape(*x.shape[:-1], gates, h)
    return F.pad(blocks, (0, hp - h)).reshape(*x.shape[:-1], gates * hp)


def pad_units(x: torch.Tensor, hp: int, dim: int = -1) -> torch.Tensor:
    """x with dimension ``dim`` (H units) padded with zeros to ``hp``."""
    h = x.shape[dim]
    if h == hp:
        return x
    widths = [0, 0] * (x.dim() - dim % x.dim() - 1) + [0, hp - h]
    return F.pad(x, widths)


def unpad_units(x: torch.Tensor, h: int) -> torch.Tensor:
    """The first ``h`` units of x's last dim, contiguous (x itself when it
    has h)."""
    return x if x.shape[-1] == h else x[..., :h].contiguous()


def pad_weight(w: torch.Tensor, gates: int, hp: int) -> torch.Tensor:
    """A weight (..., H_in, gates * H) with its input rows and each gate
    block's columns padded to ``hp``: W_hh^T of a recurrence, or W_ih^T of
    a stacked layer whose input is the layer below's h."""
    return pad_units(pad_gates(w, gates, hp), hp, dim=-2)
