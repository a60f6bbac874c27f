"""Reference PyTorch-Lightning checkpoints -> the port's checkpoints.

Counterpart of ``multimodalreactiongeneration_tpu/models/torch_import.py``.
The reference's public checkpoint format is a Lightning state_dict
(torch.load(path)["state_dict"], model_loader.py:23-25). The tables
below map its parameter paths onto the JAX package's flax paths, the
same tables as there; the port's names are those paths with "." for
"/", and ``train/checkpoint.py import_torch_state_dict`` applies a table
(the layouts already agree: Linear and LayerNorm weights, LSTM / GRU
leaves and MHA projections are torch's in both).

Reference module paths (from the constructors):
  * LSTMwithSample (lstm_with_sample.py:92-130):
      acoustic_projection.{weight,bias}
      sampling_lstm.sampler.{weight_ih_l*,weight_hh_l*,bias_*}
      layerd_lstm.lstm_layered.{i}... with ResidualConnection nesting
        (.module) when use_residual (lstm_block.py:92-99)
      feed_forward.input / feed_forward.mapping
  * SimpleLSTM (simple_lstm.py:48-143): encoders/attention/decoder
  * Metaformer (lstmformer.py:199-215, multi_modal_metaformer.py:341-474)

``convert_checkpoint`` validates the result against the model
(``load_state_dict(strict=True)``) and writes a checkpoint usable as
``model_path=<out>/last`` by the eval CLI and as ``resume_from`` by the
training CLI; ``main`` does so for a ``.ckpt`` file:

    python -m multimodalreactiongeneration_tpu_torch.models.torch_import \\
        --config configs/lstmformer.yaml --ckpt ref.ckpt --out ckpts/imported
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from multimodalreactiongeneration_tpu_torch.train.checkpoint import (
    import_torch_state_dict,
)


def lws_name_map(num_layers: int, use_residual: bool = True,
                 use_layer_norm: bool = True) -> Dict[str, str]:
    """LSTMwithSample mapping (model config num_layers blocks).

    The reference wraps each block's LSTMModule in ResidualConnection
    (prefix gains ``.module``) and keeps a LayerNorm at
    ``lstm_module.layer_norm`` (residual_connection.py:15-17); our
    LSTMBlock names them lstm_module / lstm_norm (nn/lstm_block.py).
    use_feed_forward=False for this model, so blocks have no FFN.
    """
    mapping = {
        "acoustic_projection": "acoustic_projection",
        "sampling_lstm.sampler": "sampling_lstm/sampler",
        "feature_projection": "feature_projection",
        "feed_forward.input": "ff_input",
        "feed_forward.mapping": "ff_mapping",
    }
    for i in range(num_layers):
        ref = f"layerd_lstm.lstm_layered.{i}"
        ours = f"layerd_lstm/block_{i}"
        if use_residual:
            mapping[f"{ref}.lstm_module.module.lstm_module"] = (
                f"{ours}/lstm_module/lstm_module"
            )
            mapping[f"{ref}.lstm_module.module.mixer"] = (
                f"{ours}/lstm_module/mixer"
            )
            if use_layer_norm:
                mapping[f"{ref}.lstm_module.layer_norm"] = f"{ours}/lstm_norm"
        else:
            mapping[f"{ref}.lstm_module.lstm_module"] = (
                f"{ours}/lstm_module/lstm_module"
            )
            mapping[f"{ref}.lstm_module.mixer"] = f"{ours}/lstm_module/mixer"
    return mapping


def import_lws_state_dict(
    state_dict: Mapping[str, Any], model_cfg: Dict[str, Any]
) -> Dict[str, torch.Tensor]:
    """Reference LSTMwithSample state_dict -> the port's state_dict."""
    mapping = lws_name_map(
        model_cfg["num_layers"],
        use_residual=model_cfg.get("use_residual", True),
        use_layer_norm=model_cfg.get("use_layer_norm", True),
    )
    return import_torch_state_dict(state_dict, mapping)


def _lstm_layered_map(ref_prefix: str, our_prefix: str, num_layers: int,
                      use_feed_forward: bool = True) -> Dict[str, str]:
    """LSTMLayerd with use_mixing + use_residual + use_layer_norm (the
    SimpleLSTM configuration): ResidualConnection nests the LSTMModule and
    the FFN under ``.module`` (lstm_block.py:92-99)."""
    m = {}
    for i in range(num_layers):
        ref = f"{ref_prefix}.lstm_layered.{i}"
        ours = f"{our_prefix}/block_{i}"
        m[f"{ref}.lstm_module.module.lstm_module"] = (
            f"{ours}/lstm_module/lstm_module"
        )
        m[f"{ref}.lstm_module.module.mixer"] = f"{ours}/lstm_module/mixer"
        m[f"{ref}.lstm_module.layer_norm"] = f"{ours}/lstm_norm"
        if use_feed_forward:
            m[f"{ref}.feed_forward_module.module.input"] = f"{ours}/ff_input"
            m[f"{ref}.feed_forward_module.module.mapping"] = f"{ours}/ff_mapping"
            m[f"{ref}.feed_forward_module.layer_norm"] = f"{ours}/ff_norm"
    return m


def simple_lstm_name_map(model_cfg: Dict[str, Any]) -> Dict[str, str]:
    """SimpleLSTM mapping (reference simple_lstm.py:48-143)."""
    mapping = {
        "acoustic_encoder.embed_layer": "acoustic_embed",
        "motion_encoder.embed_layer": "motion_embed",
        "motion_decoder.mapping.input": "mapping_input",
        "motion_decoder.mapping.output": "mapping_output",
    }
    mapping.update(_lstm_layered_map(
        "acoustic_encoder.acostic_lstm", "acoustic_lstm",
        model_cfg["acostic_num_layers"],
    ))
    mapping.update(_lstm_layered_map(
        "motion_encoder.motion_lstm", "motion_lstm",
        model_cfg["motion_num_layers"],
    ))
    mapping.update(_lstm_layered_map(
        "motion_decoder.decoder_lstm", "decoder_lstm",
        model_cfg["decoder_num_layers"],
    ))
    for i in range(model_cfg["att_num_layers"]):
        ref = f"multimodal_att.att_layers.{i}.att_module"
        mapping[f"{ref}.module.cross_modal_att"] = f"multimodal_att/att_{i}"
        mapping[f"{ref}.module.projection"] = f"multimodal_att/projection_{i}"
        mapping[f"{ref}.layer_norm"] = f"multimodal_att/norm_{i}"
    return mapping


def import_simple_lstm_state_dict(
    state_dict: Mapping[str, Any], model_cfg: Dict[str, Any]
) -> Dict[str, torch.Tensor]:
    return import_torch_state_dict(
        state_dict, simple_lstm_name_map(model_cfg)
    )


def _mixer_block_map(ref: str, ours: str, mixer_type: str,
                     num_internal: int, nonlinearity_none: bool) -> Dict[str, str]:
    """One MixerBlock (reference mixer_block.py:355-603, residual=True).

    ResidualConnection nests the mixer under ``.module``; FeedForward
    nests its Sequential under ``.feed_forward`` then a second time under
    ``.module`` when residual (mixer_block.py:78-83). With
    nonlinearity "none" the FFN is a single Linear named ``feedforward``
    (:63-68), else input/output (:69-76). Our FeedForward's residual
    LayerNorm is flax-autonamed LayerNorm_0.
    """
    m = {}
    if mixer_type in ("lstm", "gru"):
        m[f"{ref}.mixer.module.mixer"] = f"{ours}/mixer"
    elif mixer_type == "mha":
        for k in range(num_internal):
            m[f"{ref}.mixer.module.mixer.{k}.mha"] = f"{ours}/mha_{k}"
    m[f"{ref}.mixer.layer_norm"] = f"{ours}/mixer_norm"
    if nonlinearity_none:
        m[f"{ref}.feed_forward.feed_forward.module.feedforward"] = (
            f"{ours}/feed_forward/feedforward"
        )
    else:
        m[f"{ref}.feed_forward.feed_forward.module.input"] = (
            f"{ours}/feed_forward/input"
        )
        m[f"{ref}.feed_forward.feed_forward.module.output"] = (
            f"{ours}/feed_forward/output"
        )
    m[f"{ref}.feed_forward.feed_forward.layer_norm"] = (
        f"{ours}/feed_forward/LayerNorm_0"
    )
    return m


def metaformer_name_map(model_cfg: Dict[str, Any]) -> Dict[str, str]:
    """Metaformer mapping (reference lstmformer.py:199-215 +
    multi_modal_metaformer.py:341-474 + mixer_block.py nesting).

    Assumes the reference's shipped configuration: residual=True,
    interlayer_residual=False, input/output projections off.
    """
    n_modal = len(model_cfg["modalities"])
    main_idx = model_cfg["main_modal_idx"]
    emb_mixers = list(model_cfg["emb_mixers"])
    main_type = emb_mixers[main_idx]
    other_types = list(emb_mixers)
    other_types.pop(main_idx)
    num_block = model_cfg["num_block"]
    num_layerd = model_cfg["num_layerd"]
    enc_layerd = model_cfg["encoder_num_layer"]
    num_internal = model_cfg["num_internal_layer"]
    nl_none = model_cfg.get("nonlinearity", "none") in (None, "none")
    ffn_none = model_cfg.get("ffn_nonlinearity", "relu") in (None, "none")
    repeat = model_cfg.get("repeat_with_encoder", False)

    mapping: Dict[str, str] = {}
    for i in range(n_modal):
        mapping[f"metaformer.feature_embedding.{i}"] = (
            f"metaformer/feature_embedding_{i}"
        )
    for b in range(num_block):
        ref_b = f"metaformer.metaformer_blocks.{b}"
        ours_b = f"metaformer/block_{b}"
        encode = b == 0 or repeat
        emb_types = [main_type] + (other_types if encode else [])
        for m_i, mtype in enumerate(emb_types):
            layerd = num_layerd if m_i == 0 else enc_layerd
            for j in range(layerd):
                mapping.update(_mixer_block_map(
                    f"{ref_b}.embedding.modal_embeddings.{m_i}.mixer.{j}",
                    f"{ours_b}/emb_{m_i}/block_{j}",
                    mtype, num_internal, nl_none,
                ))
        for i in range(n_modal - 1):
            for j in range(num_layerd):
                mapping.update(_mixer_block_map(
                    f"{ref_b}.integrator.integrators.{i}.mixer.{j}",
                    f"{ours_b}/integrate_{i}/block_{j}",
                    "mha", num_internal, nl_none,
                ))
        mapping[f"{ref_b}.integrator.cat_linear"] = f"{ours_b}/cat_linear"
        # block FFN (residual): ffn_nonlinearity decides the layer names
        if ffn_none:
            mapping[f"{ref_b}.feedforward.feed_forward.module.feedforward"] = (
                f"{ours_b}/feed_forward/feedforward"
            )
        else:
            mapping[f"{ref_b}.feedforward.feed_forward.module.input"] = (
                f"{ours_b}/feed_forward/input"
            )
            mapping[f"{ref_b}.feedforward.feed_forward.module.output"] = (
                f"{ours_b}/feed_forward/output"
            )
        mapping[f"{ref_b}.feedforward.feed_forward.layer_norm"] = (
            f"{ours_b}/feed_forward/LayerNorm_0"
        )
    # output FFN: residual=False -> bare Sequential under .feed_forward
    if ffn_none:
        mapping["metaformer.output_feedforward.feed_forward.feedforward"] = (
            "metaformer/output_ff/feedforward"
        )
    else:
        mapping["metaformer.output_feedforward.feed_forward.input"] = (
            "metaformer/output_ff/input"
        )
        mapping["metaformer.output_feedforward.feed_forward.output"] = (
            "metaformer/output_ff/output"
        )
    return mapping


def import_metaformer_state_dict(
    state_dict: Mapping[str, Any], model_cfg: Dict[str, Any]
) -> Dict[str, torch.Tensor]:
    return import_torch_state_dict(state_dict, metaformer_name_map(model_cfg))


def strip_lightning_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Lightning prefixes every name with 'model.'; drop it."""
    if all(k.startswith("model.") for k in state_dict):
        return {k[len("model."):]: v for k, v in state_dict.items()}
    return dict(state_dict)


_IMPORTERS = {
    "simple_lstm": import_simple_lstm_state_dict,
    "lstm_with_sampling": import_lws_state_dict,
    "lstmformer": import_metaformer_state_dict,
}


def convert_checkpoint(
    model_type: str,
    model_cfg: Dict[str, Any],
    state_dict: Mapping[str, Any],
    out_dir: str,
    epoch: int = 0,
) -> Dict[str, torch.Tensor]:
    """Reference state_dict -> the port's, validated, -> ``out_dir/last``.

    The result must load into a fresh model of ``model_type`` with
    ``load_state_dict(strict=True)`` (same names and shapes), so a
    partial import fails here instead of leaving a half-random model.
    Returns the port's state_dict.
    """
    from multimodalreactiongeneration_tpu_torch.models import build_model
    from multimodalreactiongeneration_tpu_torch.train.checkpoint import (
        HostSnapshot,
        TopKCheckpointer,
    )

    state_dict = _IMPORTERS[model_type](strip_lightning_prefix(state_dict),
                                        model_cfg)
    model = build_model(model_type, model_cfg, device="cpu")
    try:
        model.load_state_dict(state_dict, strict=True)
    except RuntimeError as exc:
        raise ValueError(
            f"imported checkpoint does not match the model: {exc}") from exc
    TopKCheckpointer(out_dir, top_k=1).save_last(HostSnapshot(model), epoch)
    return state_dict


def main(argv=None):
    """python -m multimodalreactiongeneration_tpu_torch.models.torch_import \\
        --config configs/lstmformer.yaml --ckpt ref.ckpt --out ckpts/imported

    Reads a reference PyTorch-Lightning checkpoint (torch.load), maps it
    onto the port's parameter names, validates, and writes a checkpoint
    usable as model_path=<out>/last by the eval CLI.
    """
    import argparse

    from multimodalreactiongeneration_tpu_torch.configs import load_config

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    cfg = load_config(args.config, args.overrides)
    # a Lightning .ckpt pickles more than tensors (hyper-parameters,
    # loop state), as the JAX importer's torch.load allows
    payload = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    state_dict = payload.get("state_dict", payload)
    convert_checkpoint(
        cfg.exp.use_model,
        cfg.model.to_dict(),
        state_dict,
        args.out,
        epoch=int(payload.get("epoch", 0)) if isinstance(payload, dict) else 0,
    )
    print(f"imported {len(state_dict)} tensors -> {args.out}/last")


if __name__ == "__main__":
    main()
