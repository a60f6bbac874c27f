"""The port's state_dict -> a reference torch state_dict (inverse importer).

Counterpart of ``multimodalreactiongeneration_tpu/models/torch_export.py``:
writes a model trained with the port back out as a state_dict that the
reference's own ``load_model`` (torch.load(path)["state_dict"] ->
load_state_dict(strict=True), reference model_loader.py:13-26) accepts.

The per-model name tables are the importer's (``torch_import.py``);
``export_torch_state_dict`` inverts ``train/checkpoint.py
import_torch_state_dict``:
  * Linear and LayerNorm ``weight`` / ``bias`` and the LSTM / GRU leaves
    keep name and layout;
  * ``out_proj_weight`` / ``out_proj_bias`` -> ``out_proj.weight`` /
    ``.bias``;
  * MHA q/k/v projections are packed into ``in_proj_weight`` /
    ``in_proj_bias`` when kdim == vdim == embed_dim (torch's
    ``_qkv_same_embed_dim``), else left as ``q/k/v_proj_weight`` beside
    the packed ``in_proj_bias``, as ``torch.nn.MultiheadAttention`` holds
    them.

    python -m multimodalreactiongeneration_tpu_torch.models.torch_export \\
        --config configs/lstmformer.yaml --ckpt ckpts/run/last --out ref.ckpt
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from multimodalreactiongeneration_tpu_torch.models.torch_import import (
    lws_name_map,
    metaformer_name_map,
    simple_lstm_name_map,
)

_RNN_LEAVES = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
_QKV = tuple(f"{p}_proj_{kind}" for p in "qkv" for kind in ("weight", "bias"))


def export_torch_state_dict(
    state_dict: Mapping[str, torch.Tensor], name_map: Dict[str, str]
) -> Dict[str, torch.Tensor]:
    """Inverse of ``import_torch_state_dict``: the port's state_dict ->
    reference names.

    name_map: reference prefix -> flax path prefix (the importer's
    table; the port's prefix is the flax one with "." for "/"). Raises on
    a parameter no table entry covers: a partial export would give a
    checkpoint the reference's load_state_dict rejects anyway.
    """
    # port prefix -> reference prefix, matched longest-first on whole
    # name components
    inverse = sorted(((v.replace("/", "."), k) for k, v in name_map.items()),
                     key=lambda x: -len(x[0]))
    out: Dict[str, torch.Tensor] = {}
    qkv: Dict[str, Dict[str, torch.Tensor]] = {}  # reference base -> parts
    unmapped = []
    for path, value in state_dict.items():
        hit = next(((p, r) for p, r in inverse
                    if path.startswith(p + ".")), None)
        if hit is None:
            unmapped.append(path)
            continue
        rest = path[len(hit[0]) + 1:]
        dirs, _, leaf = rest.rpartition(".")
        base = f"{hit[1]}.{dirs}" if dirs else hit[1]
        value = value.detach().to("cpu").contiguous()
        if leaf in _QKV:
            qkv.setdefault(base, {})[leaf] = value
        elif leaf in ("out_proj_weight", "out_proj_bias"):
            out[f"{base}.out_proj.{leaf[len('out_proj_'):]}"] = value
        elif leaf.startswith(_RNN_LEAVES) or leaf in ("weight", "bias"):
            out[f"{base}.{leaf}"] = value
        else:
            unmapped.append(path)

    for base, parts in qkv.items():
        q, k, v = (parts.get(f"{p}_proj_weight") for p in "qkv")
        if q is None or k is None or v is None:
            raise ValueError(f"incomplete q/k/v projections under {base}")
        e = q.shape[0]
        if k.shape[1] == e and v.shape[1] == e:
            out[f"{base}.in_proj_weight"] = torch.cat([q, k, v], 0)
        else:  # torch keeps them separate when kdim/vdim differ
            out[f"{base}.q_proj_weight"] = q
            out[f"{base}.k_proj_weight"] = k
            out[f"{base}.v_proj_weight"] = v
        if "q_proj_bias" in parts:
            out[f"{base}.in_proj_bias"] = torch.cat(
                [parts[f"{p}_proj_bias"] for p in "qkv"], 0)

    if unmapped:
        raise ValueError(
            f"{len(unmapped)} parameters have no reference mapping, "
            f"e.g. {unmapped[:5]}"
        )
    return out


def export_simple_lstm_state_dict(state_dict, model_cfg: Dict[str, Any]):
    return export_torch_state_dict(state_dict, simple_lstm_name_map(model_cfg))


def export_lws_state_dict(state_dict, model_cfg: Dict[str, Any]):
    return export_torch_state_dict(
        state_dict,
        lws_name_map(
            model_cfg["num_layers"],
            use_residual=model_cfg.get("use_residual", True),
            use_layer_norm=model_cfg.get("use_layer_norm", True),
        ),
    )


def export_metaformer_state_dict(state_dict, model_cfg: Dict[str, Any]):
    return export_torch_state_dict(state_dict, metaformer_name_map(model_cfg))


EXPORTERS = {
    "simple_lstm": export_simple_lstm_state_dict,
    "lstm_with_sampling": export_lws_state_dict,
    "lstmformer": export_metaformer_state_dict,
}


def main(argv=None):
    """python -m multimodalreactiongeneration_tpu_torch.models.torch_export \\
        --config configs/lstmformer.yaml --ckpt ckpts/run/last --out ref.ckpt

    Reads one of the port's checkpoints and writes a PyTorch-Lightning
    style .ckpt (torch.save of {"state_dict", "epoch"}) loadable by the
    reference's model_loader.
    """
    import argparse

    from multimodalreactiongeneration_tpu_torch.configs import load_config
    from multimodalreactiongeneration_tpu_torch.train.checkpoint import (
        load_checkpoint,
    )

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", required=True, help="the port's checkpoint")
    ap.add_argument("--out", required=True, help="output .ckpt file")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    cfg = load_config(args.config, args.overrides)
    payload = load_checkpoint(args.ckpt)
    sd = EXPORTERS[cfg.exp.use_model](payload["params"], cfg.model.to_dict())
    torch.save({"state_dict": sd, "epoch": int(payload.get("epoch", 0))},
               args.out)
    print(f"exported {len(sd)} tensors -> {args.out}")


if __name__ == "__main__":
    main()
