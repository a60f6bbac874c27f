"""Weight bridge: a JAX (flax) parameter tree -> the port's state_dict.

The port's modules carry the flax paths as attribute names, so a leaf
``metaformer/block_0/emb_0/block_0/mixer/weight_ih_l0`` becomes
``metaformer.block_0.emb_0.block_0.mixer.weight_ih_l0``. Per leaf:

  * Dense ``kernel`` (in, out) -> ``weight`` (out, in), transposed;
  * LayerNorm ``scale`` -> ``weight``;
  * ``bias`` and the LSTM / GRU / MHA leaves (already in torch layout,
    under torch's names: ``weight_ih_l<k>``, ``weight_hh_l<k>``,
    ``bias_ih_l<k>``, ``bias_hh_l<k>`` for every layer k, and their
    ``_reverse`` forms; 4H rows for an LSTM, 3H for a GRU) keep name and
    layout.

Any other leaf name raises. It converts a Metaformer tree (LSTM or GRU
embeddings, tests/test_torch_port_gru.py; multi-layer and bidirectional
recurrent mixers, whose ``_l{k}`` and ``_reverse`` leaves keep their
names, and MLP mixers, whose ``input`` / ``hidden_{i}`` / ``output``
Dense kernels transpose, tests/test_torch_port_mixer_kinds.py), an
LSTMwithSample tree and a
SimpleLSTM tree (bidirectional LSTMs with their ``_reverse`` leaves,
cross-modal MHA with kdim/vdim; tests/test_torch_port_simple_lstm.py)
alike. Reference Lightning checkpoints load through
``train/checkpoint.py import_torch_state_dict`` with the name tables of
``models/torch_import.py`` (and go back out through
``models/torch_export.py``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_KEEP = {
    "bias",
    "q_proj_weight", "k_proj_weight", "v_proj_weight", "out_proj_weight",
    "q_proj_bias", "k_proj_bias", "v_proj_bias", "out_proj_bias",
}
_RNN_LEAF = re.compile(r"(weight|bias)_(ih|hh)_l\d+(_reverse)?")


def state_dict_from_jax(
    flat: Mapping[str, np.ndarray]
) -> Dict[str, torch.Tensor]:
    """``flat`` maps "/"-joined flax paths (a leading "params/" is
    dropped) to numpy arrays; returns a state_dict for the port's
    module of the same structure (e.g. ``Metaformer``)."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        leaf = parts[-1]
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{path}: Dense kernel must be 2-D")
            parts[-1] = "weight"
            arr = arr.T
        elif leaf == "scale":
            parts[-1] = "weight"
        elif leaf not in _KEEP and not _RNN_LEAF.fullmatch(leaf):
            raise KeyError(f"no mapping for parameter leaf {path!r}")
        out[".".join(parts)] = torch.from_numpy(np.array(arr, order="C"))
    return out
