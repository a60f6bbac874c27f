"""Configurations: the shipped yamls as plain dicts, and a yaml loader.

``load_config`` is the counterpart of the JAX package's
``utils/config.py load_config``: given a path, it reads the yaml there
(``parse_yaml``, a reader of the subset the shipped configs use, since
the port does not depend on PyYAML); given a bare name (``lstmformer``),
it takes the built-in dict of that name from ``CONFIGS``. Then it
applies ``key=value`` dotted overrides with YAML-typed values, resolves
the ``${a.b}`` interpolations and returns a ``Config`` (a dict with
attribute access). The tests hold every dict of ``CONFIGS`` equal to its
yaml and the resolved config equal to the JAX loader's.

``LSTMFORMER`` is ``configs/lstmformer.yaml`` as written: every group,
with its ``${a.b}`` interpolations and ``???`` mandatory values.
``LSTMFORMER_MODEL_CFG`` (the keys the model reads), ``LSTMFORMER_LOSS_CFG``,
``LSTMFORMER_METRICS_CFG`` and ``LSTMFORMER_OPTIM_CFG`` (what the training
step reads) are cut from the resolved config: the flagship Metaformer at
the production size (hidden 256, 5 blocks, LSTM embeddings, encoders of
5 mixer blocks, 4-head integrators, 10 s context budget).

``LSTMFORMER_GRU`` is ``configs/lstmformer_gru.yaml``, the lstmformer's
dict with ``emb_mixers`` three GRUs, and ``LSTMFORMER_GRU_MODEL_CFG`` is
cut from it as ``LSTMFORMER_MODEL_CFG`` is (its loss, metrics and optim
groups are the lstmformer's).

``LSTM_WITH_SAMPLING`` is ``configs/lstm_with_sampling.yaml`` in the same
way, and ``LWS_MODEL_CFG``, ``LWS_LOSS_CFG``, ``LWS_METRICS_CFG`` and
``LWS_OPTIM_CFG`` are cut from it: the reference's second model at its
published size (a 2-layer 128-wide LSTM sampler, two 256-wide
layered-LSTM blocks, batch 256).

``SIMPLE_LSTM`` is ``configs/simple_lstm.yaml`` and ``SIMPLE_LSTM_BEST``
``configs/simple_lstm_best.yaml`` (``all_static`` off); ``SIMPLE_LSTM_MODEL_CFG``
(its whole ``model:`` group), ``SIMPLE_LSTM_METRICS_CFG`` and
``SIMPLE_LSTM_OPTIM_CFG`` are cut from the first: the reference's third
model (bidirectional 128-wide LSTM encoders over 256-wide affines, 8-head
cross-modal attention, a 5-block decoder, batch 256, 15-frame context).
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

MANDATORY = "???"
_INTERP_RE = re.compile(r"\$\{([^}]+)\}")

LSTMFORMER: Dict[str, Any] = {
    "project": "Head-Motion_LSTMformer",
    "name": "cradle-01",
    "version": None,
    "hidden_size": 256,
    "bottleneck_size": 64,
    "lr": 5e-06,
    "batch_size": 128,
    "max_epochs": 60,
    "optim_epochs": 100,
    "use_centroid": True,
    "use_angle": True,
    "sample_rate": 16000,
    "nfft": 400,
    "shift": 160,
    "nmels": 26,
    "delta_order": 2,
    "data_dir": "???",
    "no_cache_build": False,
    "clear_cache": False,
    "ckpt_path": "???",
    "log_dir": "???",
    "device": "tpu",
    "seed": 0,
    "model": {
        "main_modal_idx": 2,
        "hidden_size": "${hidden_size}",
        "num_block": 5,
        "dropout": 0.0,
        "num_layerd": 1,
        "encoder_num_layer": 5,
        "num_internal_layer": 1,
        "residual": True,
        "residual_layer_norm": True,
        "bias": True,
        "emb_mixers": ["lstm", "lstm", "lstm"],
        "bottleneck_size": "${bottleneck_size}",
        "nonlinearity": "none",
        "ffn_nonlinearity": "relu",
        "proj_size": 0,
        "num_heads": 4,
        "add_bias_kv": False,
        "add_zero_attn": False,
        "max_context_len": 10,
        "repeat_with_encoder": False,
        "interlayer_residual": False,
        "interlayer_residual_norm": True,
        "sampling_rate": "${sample_rate}",
        "shift": "${shift}",
        "pred_fps": "${motion.pred_fps}",
        "modalities": ["audio", "motion", "motion"],
        "use_centroid": "${use_centroid}",
        "use_angle": "${use_angle}",
        "nmels": "${nmels}",
        "delta_order": "${delta_order}",
        "loss_type": "huber",
        "loss_reduction": "mean",
        "huber_delta": 1.0,
        "smoothl1_beta": 1.0,
        "delta_loss_scale": 1,
        "use_scheduled_sampling": False,
        "max_epochs": "${max_epochs}",
    },
    "metrics": {
        "use_centroid": "${use_centroid}",
        "use_angle": "${use_angle}",
        "delta_order": "${delta_order}",
    },
    "trainer": {
        "max_epochs": "${max_epochs}",
        "log_every_n_steps": 50,
        "precision": 32,
        "val_check_interval": 0.25,
        "pad_to_multiple": 16,
        "run_generation_eval": True,
    },
    "callbacks": {
        "save_top_k": 5,
        "patience_epoch": 10,
        "use_checkpoint": True,
        "use_early_stopping": True,
        "async_checkpoint": True,
        "save_opt_state": "last",
    },
    "optim": {
        "use_optimizer": "adam",
        "momentum": 0.9,
        "weight_decay": 0.01,
        "lr": "${lr}",
        "use_lr_sched": True,
        "batch_size": "${batch_size}",
        "max_epochs": "${optim_epochs}",
    },
    "exp": {
        "use_model": "lstmformer",
        "batch_size": "${batch_size}",
        "train_rate": 0.8,
        "valid_rate": 0.1,
        "use_logger": "jsonl",
    },
    "data": {
        "no_cache_build": "${no_cache_build}",
        "clear_cache": "${clear_cache}",
        "data_dir": "${data_dir}",
        "fps": "${motion.fps}",
        "pred_fps": "${motion.pred_fps}",
        "pred_shift": "${motion.pred_shift}",
        "max_len": "${motion.max_len}",
        "min_len": "${motion.min_len}",
        "shift_len": "${motion.shift_len}",
        "leading_len": "${motion.leading_len}",
        "sample_rate": "${sample_rate}",
        "nfft": "${nfft}",
        "shift": "${shift}",
        "threshold": "${utterance.threshold}",
        "minimum_utterance_length": "${utterance.minimum_utterance_length}",
        "pause_with_voice": "${utterance.pause_with_voice}",
        "pause_without_voice": "${utterance.pause_without_voice}",
        "mergin": "${utterance.mergin}",
        "use_partner_motion": True,
        "use_partner_audio": True,
        "use_self_motion": True,
        "use_self_audio": False,
        "target_shift": 1,
        "use_centroid": "${use_centroid}",
        "use_angle": "${use_angle}",
        "delta_order": "${delta_order}",
    },
    "motion": {
        "fps": 25,
        "pred_fps": 12.5,
        "pred_shift": 2,
        "max_len": 250,
        "min_len": 125,
        "shift_len": 250,
        "leading_len": 25,
        "use_centroid": "${use_centroid}",
        "use_angle": "${use_angle}",
        "delta_order": "${delta_order}",
        "train_by_std": True,
    },
    "audio": {
        "sample_rate": "${sample_rate}",
        "nfft": "${nfft}",
        "shift": "${shift}",
        "nmels": "${nmels}",
        "delta_order": "${delta_order}",
    },
    "utterance": {
        "sample_rate": "${sample_rate}",
        "window_size": "${nfft}",
        "stride": "${shift}",
        "threshold": -4,
        "minimum_utterance_length": 1.0,
        "pause_with_voice": 1.0,
        "pause_without_voice": 2.0,
        "mergin": 1.0,
    },
    "model_type": "lstmformer",
    "model_path": None,
    "model_conf": None,
    "movie_path": None,
    "audio_path": None,
    "output_path": None,
}

# ``configs/lstm_with_sampling.yaml``: its own top level and model, exp
# and audio groups; every other group is written as the lstmformer's
LSTM_WITH_SAMPLING: Dict[str, Any] = {
    "project": "Head-Motion_LSTM-with-Sampling",
    "name": "cradle-01",
    "version": None,
    "hidden_size": 256,
    "bottleneck_size": 64,
    "lr": 5e-06,
    "batch_size": 256,
    "max_epochs": 60,
    "optim_epochs": 100,
    "use_centroid": True,
    "use_angle": True,
    "delta_order": 2,
    "sample_rate": 16000,
    "nfft": 400,
    "shift": 160,
    "data_dir": "???",
    "no_cache_build": False,
    "clear_cache": False,
    "ckpt_path": "???",
    "log_dir": "???",
    "device": "tpu",
    "seed": 0,
    "model": {
        "nmels": "${audio.nmels}",
        "delta_order": "${delta_order}",
        "use_centroid": "${use_centroid}",
        "use_angle": "${use_angle}",
        "sampler_hidden_size": 128,
        "sampler_num_layers": 2,
        "sampler_dropout_rate": 0,
        "sampling_rate": "${sample_rate}",
        "shift": "${shift}",
        "fps": "${motion.fps}",
        "pred_fps": "${motion.pred_fps}",
        "hidden_size": "${hidden_size}",
        "bottleneck_size": "${bottleneck_size}",
        "num_layers": 2,
        "num_lstm": 1,
        "dropout_rate": 0.0,
        "use_layer_norm": True,
        "use_relu": True,
        "use_mixing": False,
        "use_residual": True,
        "delta_loss_scale": 1,
        "loss_type": "huber",
        "loss_reduction": "mean",
        "huber_delta": 1.0,
        "smoothl1_beta": 1.0,
        "use_scheduled_sampling": False,
        "max_epochs": "${max_epochs}",
    },
    **{group: copy.deepcopy(LSTMFORMER[group]) for group in (
        "metrics", "trainer", "callbacks", "optim")},
    "exp": dict(LSTMFORMER["exp"], use_model="lstm_with_sampling"),
    **{group: copy.deepcopy(LSTMFORMER[group]) for group in (
        "data", "motion")},
    "audio": dict(LSTMFORMER["audio"], nmels=26),
    "utterance": copy.deepcopy(LSTMFORMER["utterance"]),
    "model_type": "lstm_with_sampling",
    "model_path": None,
    "model_conf": None,
    "movie_path": None,
    "audio_path": None,
    "output_path": None,
}

# ``configs/lstmformer_gru.yaml``: the lstmformer's with GRU embeddings
LSTMFORMER_GRU: Dict[str, Any] = {
    **copy.deepcopy(LSTMFORMER),
    "model": dict(copy.deepcopy(LSTMFORMER["model"]),
                  emb_mixers=["gru", "gru", "gru"]),
}

# ``configs/simple_lstm.yaml``; ``simple_lstm_best.yaml`` differs only in
# ``model.all_static``
SIMPLE_LSTM: Dict[str, Any] = {
    "project": "Multimodal-Head-Motion-Prediction",
    "name": "cradle-01",
    "version": None,
    "hidden_size": 256,
    "lstm_size": 128,
    "bottleneck_size": 64,
    "lr": 5e-06,
    "batch_size": 256,
    "max_epochs": 60,
    "optim_epochs": 100,
    "use_centroid": True,
    "use_angle": True,
    "motion_stride": 2,
    "delta_order": 2,
    "sample_rate": 16000,
    "nfft": 400,
    "shift": 160,
    "data_dir": "???",
    "no_cache_build": False,
    "clear_cache": False,
    "ckpt_path": "???",
    "log_dir": "???",
    "device": "tpu",
    "seed": 0,
    "model": {
        "acostic_feat_size": 81,
        "motion_feat_size": 18,
        "motion_num_lstm": 1,
        "acostic_num_lstm": 1,
        "acostic_num_layers": 2,
        "motion_num_layers": 2,
        "acostic_lstm_size": "${lstm_size}",
        "motion_lstm_size": "${lstm_size}",
        "acostic_lstm_out_size": "${hidden_size}",
        "motion_lstm_out_size": "${hidden_size}",
        "acostic_affine_size": "${hidden_size}",
        "motion_affine_size": "${hidden_size}",
        "acostic_bottleneck_size": "${bottleneck_size}",
        "motion_bottleneck_size": "${bottleneck_size}",
        "acostic_output_size": "${hidden_size}",
        "motion_output_size": "${hidden_size}",
        "att_heads": 8,
        "att_num_layers": 3,
        "att_use_residual": True,
        "att_use_layer_norm": True,
        "dropout_rate": 0,
        "output_size": 18,
        "bidirectional": True,
        "use_layer_norm": True,
        "use_relu": True,
        "use_mixing": True,
        "use_residual": True,
        "decoder_num_layers": 5,
        "decoder_num_lstm": 1,
        "decoder_lstm_size": "${lstm_size}",
        "decoder_affine_size": "${hidden_size}",
        "decoder_bottleneck_size": "${bottleneck_size}",
        "decoder_output_size": "${hidden_size}",
        "decoder_mapping_size": 64,
        "decoder_bidirectional": True,
        "decoder_use_layer_norm": True,
        "decoder_use_relu": True,
        "decoder_use_mixing": True,
        "decoder_use_residual": True,
        "delta_loss_scale": 1,
        "all_static": True,
    },
    "metrics": copy.deepcopy(LSTMFORMER["metrics"]),
    "trainer": {k: LSTMFORMER["trainer"][k] for k in (
        "max_epochs", "log_every_n_steps", "precision", "val_check_interval")},
    **{group: copy.deepcopy(LSTMFORMER[group]) for group in (
        "callbacks", "optim")},
    "exp": dict(LSTMFORMER["exp"], use_model="simple_lstm", train_rate=0.9,
                valid_rate=0.05),
    "data": {
        "data_dir": "${data_dir}",
        "fps": 25,
        "context_start": -30,
        "sample_stride": 2,
        "context_size": 15,
        "context_stride": "${motion_stride}",
        "target_type": "direct",
        "target_position": 0,
        "target_size": 1,
        "target_stride": "${motion_stride}",
        **{k: LSTMFORMER["data"][k] for k in (
            "delta_order", "no_cache_build", "clear_cache", "sample_rate",
            "nfft", "shift", "use_centroid", "use_angle")},
    },
    "audio": dict(LSTMFORMER["audio"], nmels=26),
    "model_type": "simple_lstm",
    "model_path": None,
    "model_conf": None,
    "movie_path": None,
    "audio_path": None,
    "output_path": None,
}
SIMPLE_LSTM_BEST: Dict[str, Any] = {
    **copy.deepcopy(SIMPLE_LSTM),
    "model": dict(copy.deepcopy(SIMPLE_LSTM["model"]), all_static=False),
}

CONFIGS: Dict[str, Dict[str, Any]] = {
    "lstmformer": LSTMFORMER,
    "lstmformer_gru": LSTMFORMER_GRU,
    "lstm_with_sampling": LSTM_WITH_SAMPLING,
    "simple_lstm": SIMPLE_LSTM,
    "simple_lstm_best": SIMPLE_LSTM_BEST,
}


class MandatoryValueError(KeyError):
    """A ``???`` value was read before it was given."""


class Config(dict):
    """A resolved config group: a dict with attribute access, nested
    groups as ``Config``s. Reading a ``???`` value raises; ``get``
    defaults only absent keys."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        if isinstance(value, str) and value == MANDATORY:
            raise MandatoryValueError(f"mandatory config key '{key}' not set")
        return value

    def get(self, key, default=None):
        return self[key] if key in self else default

    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except MandatoryValueError:
            raise
        except KeyError as exc:
            raise AttributeError(f"no config key '{key}'") from exc

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, Config) else v
                for k, v in self.items()}


def _wrap(value):
    if isinstance(value, dict):
        return Config({k: _wrap(v) for k, v in value.items()})
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


def _lookup(root, dotted: str):
    node = root
    for part in dotted.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def _resolve_value(root, value, stack: tuple):
    if not isinstance(value, str):
        return value
    full = _INTERP_RE.fullmatch(value)
    if full:
        ref = full.group(1)
        if ref in stack:
            raise ValueError(f"interpolation cycle via ${{{ref}}}")
        return _resolve_value(root, _lookup(root, ref), stack + (ref,))
    if _INTERP_RE.search(value):
        def sub(match):
            ref = match.group(1)
            if ref in stack:
                raise ValueError(f"interpolation cycle via ${{{ref}}}")
            return str(_resolve_value(root, _lookup(root, ref),
                                      stack + (ref,)))
        return _INTERP_RE.sub(sub, value)
    return value


def _resolve_tree(root, node):
    if isinstance(node, dict):
        return {k: _resolve_tree(root, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_tree(root, v) for v in node]
    return _resolve_value(root, node, ())


_BOOLS = {**{w: True for w in ("y", "Y", "yes", "Yes", "YES", "true", "True",
                                "TRUE", "on", "On", "ON")},
          **{w: False for w in ("n", "N", "no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")}}
_NULLS = ("~", "null", "Null", "NULL")
_INT_RE = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT_RE = re.compile(
    r"^[-+]?(\d[\d_]*)?\.[\d_]*([eE][-+]?\d+)?$|^[-+]?\d+[eE][-+]?\d+$")


def parse_value(text: str) -> Any:
    """A YAML 1.1 scalar or flow list, as the JAX loader's overrides read
    it: bools (true/yes/on ...), null, ints, floats (``5e-6`` too), quoted
    strings, ``[a, b]`` lists; anything else is the string itself."""
    t = text.strip()
    if t == "" or t in _NULLS:
        return None if t else ""
    if t in _BOOLS:
        return _BOOLS[t]
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        return [parse_value(x) for x in inner.split(",")] if inner else []
    if _INT_RE.match(t):
        return int(t.replace("_", ""))
    if _FLOAT_RE.match(t) and any(ch.isdigit() for ch in t):
        return float(t.replace("_", ""))
    if t.lower() in (".inf", "+.inf"):
        return float("inf")
    if t.lower() == "-.inf":
        return float("-inf")
    if t.lower() == ".nan":
        return float("nan")
    return text


def apply_overrides(raw: Dict[str, Any], overrides: List[str]) -> None:
    """Apply ``a.b.c=value`` overrides to an unresolved config in place
    (before interpolation, as the JAX loader does)."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must look like key=value, got {item!r}")
        dotted, _, text = item.partition("=")
        parts = dotted.strip().split(".")
        node = raw
        for part in parts[:-1]:
            if not isinstance(node.get(part), dict):
                node[part] = {}
            node = node[part]
        node[parts[-1]] = parse_value(text)


def _strip_comment(line: str) -> str:
    """The line up to a ``#`` that starts a comment: at the line's start
    or after a blank, outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> Any:
    """The subset of YAML the shipped configs use: nested mappings by
    indentation, block (``- a``) and flow (``[a, b]``) lists of scalars,
    scalars typed as ``parse_value`` types them (``5e-6`` is a float, as
    in the JAX loader), empty values as null, ``#`` comments. ``???`` and
    ``${a.b}`` stay strings until ``load_config`` resolves them. Anything
    else (anchors, multi-line strings, tabs) raises ``ValueError``."""
    lines = []
    for no, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"line {no}: tab in indentation")
        lines.append((no, len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    value, end = _parse_block(lines, 0, lines[0][1])
    if end != len(lines):
        raise ValueError(f"line {lines[end][0]}: bad indentation")
    return value


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _parse_block(lines, i: int, indent: int):
    """The mapping or list whose entries start at ``indent`` from line
    ``i``; returns (value, index of the first line after it)."""
    if _is_item(lines[i][2]):
        items = []
        while (i < len(lines) and lines[i][1] == indent
               and _is_item(lines[i][2])):
            no, _, text = lines[i]
            item = text[1:].strip()
            if (not item or _is_item(item) or item.endswith(":")
                    or ": " in item):
                raise ValueError(f"line {no}: only scalar list items are read")
            items.append(parse_value(item))
            i += 1
        return items, i
    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i][1] == indent:
        no, _, text = lines[i]
        key, sep, rest = text.partition(":")
        if not sep or (rest and not rest[0].isspace()) or _is_item(text):
            raise ValueError(f"line {no}: expected 'key: value', got {text!r}")
        key, rest = key.strip(), rest.strip()
        i += 1
        if rest:
            if rest[0] in "|>&*!":
                raise ValueError(f"line {no}: {rest[0]!r} values are not read")
            out[key] = parse_value(rest)
        elif i < len(lines) and (lines[i][1] > indent or (
                lines[i][1] == indent and _is_item(lines[i][2]))):
            out[key], i = _parse_block(lines, i, lines[i][1])
        else:
            out[key] = None
    return out, i


def load_config(path: str, overrides: Optional[List[str]] = None) -> Config:
    """The config at ``path`` (a yaml file), or the built-in dict named
    ``path`` when it is a bare name (a key of ``CONFIGS``), with
    ``overrides`` applied and interpolations resolved."""
    if Path(path).is_file():
        raw = parse_yaml(Path(path).read_text(encoding="utf-8")) or {}
    elif path in CONFIGS:
        raw = copy.deepcopy(CONFIGS[path])
    else:
        raise FileNotFoundError(
            f"no config file {path!r} (bare names {sorted(CONFIGS)} take "
            "the built-in dicts)")
    apply_overrides(raw, overrides or [])
    return _wrap(_resolve_tree(raw, raw))


_METAFORMER_KEYS = (
    "main_modal_idx", "hidden_size", "num_block", "dropout", "num_layerd",
    "encoder_num_layer", "num_internal_layer", "residual",
    "residual_layer_norm", "bias", "emb_mixers", "bottleneck_size",
    "nonlinearity", "ffn_nonlinearity", "proj_size", "num_heads",
    "add_bias_kv", "add_zero_attn", "max_context_len", "repeat_with_encoder",
    "interlayer_residual", "interlayer_residual_norm", "sampling_rate",
    "shift", "pred_fps", "modalities", "use_centroid", "use_angle", "nmels",
    "delta_order")
_RESOLVED = load_config("lstmformer").to_dict()
LSTMFORMER_MODEL_CFG = {k: _RESOLVED["model"][k] for k in _METAFORMER_KEYS}
_GRU = load_config("lstmformer_gru").to_dict()
LSTMFORMER_GRU_MODEL_CFG = {k: _GRU["model"][k] for k in _METAFORMER_KEYS}
# the loss keys of the same ``model:`` group, which the training step
# reads beside the model's own
LSTMFORMER_LOSS_CFG = {k: _RESOLVED["model"][k] for k in (
    "loss_type", "loss_reduction", "huber_delta", "smoothl1_beta",
    "delta_loss_scale")}
LSTMFORMER_METRICS_CFG = dict(_RESOLVED["metrics"])
LSTMFORMER_OPTIM_CFG = {k: _RESOLVED["optim"][k] for k in (
    "use_optimizer", "momentum", "weight_decay", "lr")}

_LWS = load_config("lstm_with_sampling").to_dict()
LWS_MODEL_CFG = {k: _LWS["model"][k] for k in (
    "nmels", "delta_order", "use_centroid", "use_angle",
    "sampler_hidden_size", "sampler_num_layers", "sampler_dropout_rate",
    "sampling_rate", "shift", "fps", "pred_fps", "hidden_size",
    "bottleneck_size", "num_layers", "num_lstm", "dropout_rate",
    "use_layer_norm", "use_relu", "use_mixing", "use_residual")}
LWS_LOSS_CFG = {k: _LWS["model"][k] for k in (
    "loss_type", "loss_reduction", "huber_delta", "smoothl1_beta",
    "delta_loss_scale")}
LWS_METRICS_CFG = dict(_LWS["metrics"])
LWS_OPTIM_CFG = {k: _LWS["optim"][k] for k in (
    "use_optimizer", "momentum", "weight_decay", "lr")}

_SIMPLE = load_config("simple_lstm").to_dict()
SIMPLE_LSTM_MODEL_CFG = _SIMPLE["model"]
SIMPLE_LSTM_METRICS_CFG = dict(_SIMPLE["metrics"])
SIMPLE_LSTM_OPTIM_CFG = {k: _SIMPLE["optim"][k] for k in (
    "use_optimizer", "momentum", "weight_decay", "lr")}
