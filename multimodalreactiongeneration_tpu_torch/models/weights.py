"""Weight bridge: a JAX (flax) parameter tree -> the port's state_dict.

The port's modules carry the flax paths as attribute names, so a leaf
``metaformer/block_0/emb_0/block_0/mixer/weight_ih_l0`` becomes
``metaformer.block_0.emb_0.block_0.mixer.weight_ih_l0``. Per leaf:

  * Dense ``kernel`` (in, out) -> ``weight`` (out, in), transposed;
  * LayerNorm ``scale`` -> ``weight``;
  * ``bias`` and the LSTM / MHA leaves (already in torch layout, under
    torch's names) keep name and layout.

Any other leaf name raises. Loading reference Lightning checkpoints
(a numpy port of the JAX package's ``metaformer_name_map``) comes with
the checkpoint slice.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_KEEP = {
    "bias",
    "weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0",
    "q_proj_weight", "k_proj_weight", "v_proj_weight", "out_proj_weight",
    "q_proj_bias", "k_proj_bias", "v_proj_bias", "out_proj_bias",
}


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
        elif leaf not in _KEEP:
            raise KeyError(f"no mapping for parameter leaf {path!r}")
        out[".".join(parts)] = torch.from_numpy(np.array(arr, order="C"))
    return out
