"""PyTorch port: reference (Lightning) checkpoints in both directions.

On reference-style state dicts, built by the pure-torch replicas of the
reference module trees that the JAX import tests use, for the Metaformer
with LSTM, GRU and MHA embeddings, LSTMwithSample and SimpleLSTM:

  * the port's import equals ``state_dict_from_jax`` of the JAX import
    bit for bit, key for key, and loads with ``strict=True``;
  * the port's forward on it matches the JAX forward on the JAX import
    (2e-5 abs; 3e-5 with GRU and MHA embeddings, as the JAX import tests
    hold them) and the reference replica's output;
  * the port's name tables are the JAX tables;
  * the export of a model's weights equals the JAX export of the same
    weights bit for bit, ``import(export(sd)) == sd``, and the reference
    replica loads it with ``strict=True``;
  * a name no table covers is skipped on import, as the JAX importer
    skips it, and raises on export;
  * ``convert_checkpoint`` writes a checkpoint the port loads, and
    ``torch_import.main`` / ``torch_export.main`` go through files.
The eval CLI on a converted checkpoint is in test_torch_port_eval_cli.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn as tnn

from multimodalreactiongeneration_tpu.models import torch_export as jexport
from multimodalreactiongeneration_tpu.models import torch_import as jimport
from multimodalreactiongeneration_tpu.models.lstm_with_sampling import (
    LSTMwithSample as JaxLWS,
)
from multimodalreactiongeneration_tpu.models.lstmformer import (
    Metaformer as JaxMetaformer,
)
from multimodalreactiongeneration_tpu.models.simple_lstm import (
    SimpleLSTM as JaxSimpleLSTM,
)
from multimodalreactiongeneration_tpu_torch.infer.generate import (
    generate_metaformer,
    sampling_mask_for,
)
from multimodalreactiongeneration_tpu_torch.models import (
    build_model,
    torch_export,
    torch_import,
)
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.train.checkpoint import (
    import_torch_state_dict,
    load_checkpoint,
)
from tests import test_torch_import_lws as ref_lws
from tests import test_torch_import_metaformer as ref_mf
from tests import test_torch_import_simple as ref_simple
from tests.test_simple_lstm import CFG as SIMPLE_CFG
from tests.test_torch_port_weights import flat_params

torch.set_num_threads(1)
RATIO = 8
SIMPLE_MAP_CFG = dict(SIMPLE_CFG, motion_bottleneck_size=64,
                      acostic_bottleneck_size=64)


def _to_torch_mask(m, heads):
    t = torch.from_numpy(np.array(m))[:, None].repeat(1, heads, 1, 1)
    return t.reshape(-1, m.shape[1], m.shape[2])


def _mf_inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 4 * RATIO, 81), (2, 4, 18), (2, 4, 18))]


def _metaformer_reference(kind, seed):
    """(reference replica, its output, the inputs, the config)."""
    from multimodalreactiongeneration_tpu.ops.masks import (
        merged_attention_mask,
    )

    torch.manual_seed(seed)
    cfg = dict(ref_mf.CFG)
    a, mp, ms = _mf_inputs(seed)
    ma = merged_attention_mask(ms, a)
    mm = merged_attention_mask(ms, mp)
    heads = cfg["num_heads"]
    masks = [_to_torch_mask(ma, heads), _to_torch_mask(mm, heads)]
    t = [torch.from_numpy(x) for x in (a, mp, ms)]
    if kind == "mha":
        model = ref_mf.RefMetaformerMhaAudio()
        cfg["emb_mixers"] = ["mha", "lstm", "lstm"]
        aa = _to_torch_mask(merged_attention_mask(a, a), heads)
        with torch.no_grad():
            y = model(t[2], t[:2], masks, aa)
        return model, y, (a, mp, ms), cfg
    model = ref_mf.RefMetaformer()
    if kind == "gru":
        for blk in model.metaformer.metaformer_blocks:
            for layerd in blk.embedding.modal_embeddings:
                for mixer_block in layerd.mixer:
                    mixer_block.mixer.module.mixer = tnn.GRU(
                        ref_mf.H, ref_mf.H, batch_first=True)
        cfg["emb_mixers"] = ["gru", "gru", "gru"]
    with torch.no_grad():
        y = model(t[2], t[:2], masks)
    return model, y, (a, mp, ms), cfg


def _lws_reference(seed):
    torch.manual_seed(seed)
    model = ref_lws.TorchRefLSTMwithSample(ref_lws.CFG)
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((2, 6 * RATIO, 81), (2, 6, 18), (2, 6, 18))]
    with torch.no_grad():
        y = model(*[torch.from_numpy(x) for x in xs])
    return model, y, xs, dict(ref_lws.CFG)


def _simple_reference(seed):
    torch.manual_seed(seed)
    model = ref_simple.RefSimpleLSTM(dict(SIMPLE_CFG))
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((2, 48, 81), (2, 10, 18))]
    with torch.no_grad():
        y = model(*[torch.from_numpy(x) for x in xs])
    return model, y, xs, SIMPLE_MAP_CFG


# model type, reference builder, JAX model, JAX importer, port importer,
# forward tolerance
VARIANTS = {
    "metaformer_lstm": ("lstmformer",
                        lambda s: _metaformer_reference("lstm", s),
                        JaxMetaformer,
                        jimport.import_metaformer_state_dict,
                        torch_import.import_metaformer_state_dict, 2e-5),
    "metaformer_gru": ("lstmformer",
                       lambda s: _metaformer_reference("gru", s),
                       JaxMetaformer,
                       jimport.import_metaformer_state_dict,
                       torch_import.import_metaformer_state_dict, 3e-5),
    "metaformer_mha": ("lstmformer",
                       lambda s: _metaformer_reference("mha", s),
                       JaxMetaformer,
                       jimport.import_metaformer_state_dict,
                       torch_import.import_metaformer_state_dict, 3e-5),
    "lstm_with_sampling": ("lstm_with_sampling", _lws_reference, JaxLWS,
                           jimport.import_lws_state_dict,
                           torch_import.import_lws_state_dict, 2e-5),
    "simple_lstm": ("simple_lstm", _simple_reference, JaxSimpleLSTM,
                    jimport.import_simple_lstm_state_dict,
                    torch_import.import_simple_lstm_state_dict, 2e-5),
}


def _numpy_sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _port_forward(model, xs):
    with torch.no_grad():
        out = model(*[torch.from_numpy(x) for x in xs])
    return (out[0] if isinstance(out, tuple) else out).numpy()


def _jax_forward(model_cls, cfg, params, xs):
    out = model_cls(cfg=cfg).apply({"params": params},
                                   *[jnp.asarray(x) for x in xs])
    return np.asarray(out[0] if isinstance(out, tuple) else out)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_import_matches_jax_import_and_forward(variant):
    model_type, make_ref, jax_cls, jax_import, port_import, atol = (
        VARIANTS[variant])
    ref, ref_y, xs, cfg = make_ref(3)
    sd = _numpy_sd(ref)
    jax_params = jax_import(sd, cfg)
    want = state_dict_from_jax(flat_params(jax_params))
    # torch tensors in, and numpy arrays in, give the same bits
    got = port_import({k: v.clone() for k, v in ref.state_dict().items()},
                      cfg)
    assert set(got) == set(want)
    for name, value in got.items():
        assert value.dtype == torch.float32 and value.is_contiguous(), name
        assert torch.equal(value, want[name]), name
    assert all(torch.equal(v, want[k])
               for k, v in port_import(sd, cfg).items())

    port = build_model(model_type, cfg, device="cpu")
    port.load_state_dict(got, strict=True)
    port_y = _port_forward(port, xs)
    jax_y = _jax_forward(jax_cls, cfg, jax_params, xs)
    np.testing.assert_allclose(port_y, jax_y, atol=atol)
    np.testing.assert_allclose(port_y, ref_y.numpy(), atol=atol)


@pytest.mark.parametrize("cfg_name", ["lstm", "gru", "mha", "ffn_none",
                                      "repeat"])
def test_name_tables_are_the_jax_tables(cfg_name):
    cfg = dict(ref_mf.CFG)
    if cfg_name in ("gru", "mha"):
        cfg["emb_mixers"] = [cfg_name, "lstm", cfg_name]
    elif cfg_name == "ffn_none":
        cfg.update(ffn_nonlinearity="none", nonlinearity="relu")
    elif cfg_name == "repeat":
        cfg.update(repeat_with_encoder=True, num_internal_layer=2)
    assert (torch_import.metaformer_name_map(cfg)
            == jimport.metaformer_name_map(cfg))
    assert (torch_import.simple_lstm_name_map(SIMPLE_MAP_CFG)
            == jimport.simple_lstm_name_map(SIMPLE_MAP_CFG))
    for residual in (True, False):
        assert (torch_import.lws_name_map(3, residual, residual)
                == jimport.lws_name_map(3, residual, residual))


def test_mha_embeddings_import_but_do_not_decode():
    """An imported mha-embedding Metaformer decodes on the in-loop
    shared-KV path (the hoist refuses mha other-modality embeddings), as
    the JAX decode of the JAX import does: teacher-forced f32 caches,
    1e-4 abs."""
    from multimodalreactiongeneration_tpu.infer.generate import (
        generate_metaformer as jax_generate,
    )

    ref, _, xs, cfg = _metaformer_reference("mha", 5)
    sd = _numpy_sd(ref)
    port = build_model("lstmformer", cfg, device="cpu")
    port.load_state_dict(torch_import.import_metaformer_state_dict(sd, cfg),
                         strict=True)
    rng = np.random.default_rng(6)
    batch = [rng.standard_normal(s).astype(np.float32)
             for s in ((2, 4 * RATIO, 81), (2, 4, 18), (2, 4, 18),
                       (2, 2 * RATIO, 81), (2, 2, 18), (2, 2, 18),
                       (2, 4, 18))]
    teacher = np.zeros(4, bool)
    got = generate_metaformer(
        port, [torch.from_numpy(x) for x in batch],
        torch.from_numpy(teacher), cache_dtype=torch.float32).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_generate(
            JaxMetaformer(cfg=cfg),
            {"params": jimport.import_metaformer_state_dict(sd, cfg)},
            tuple(jnp.asarray(x) for x in batch), jnp.asarray(teacher),
            cache_dtype=jnp.float32))
    assert got.shape == want.shape == (2, 4, 18)
    np.testing.assert_allclose(got, want, atol=1e-4)


def _jax_init(variant, seed):
    """(port model type, config, JAX params) at the JAX export tests'
    shapes."""
    model_type, make_ref, jax_cls, _, _, _ = VARIANTS[variant]
    _, _, xs, cfg = make_ref(seed)
    params = jax_cls(cfg=cfg).init(jax.random.PRNGKey(seed),
                                   *[jnp.asarray(x) for x in xs])
    return model_type, cfg, params["params"]


_EXPORTERS = {
    "lstmformer": jexport.export_metaformer_state_dict,
    "lstm_with_sampling": jexport.export_lws_state_dict,
    "simple_lstm": jexport.export_simple_lstm_state_dict,
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_export_matches_jax_export_and_round_trips(variant):
    model_type, cfg, params = _jax_init(variant, 7)
    port_sd = state_dict_from_jax(flat_params({"params": params}))
    want = _EXPORTERS[model_type](params, cfg)
    got = torch_export.EXPORTERS[model_type](port_sd, cfg)
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_array_equal(value.numpy(), want[name], err_msg=name)
    back = torch_import._IMPORTERS[model_type](got, cfg)
    assert set(back) == set(port_sd)
    assert all(torch.equal(back[k], port_sd[k]) for k in port_sd)
    # the reference replica takes the export as it is
    if variant == "lstm_with_sampling":
        ref_lws.TorchRefLSTMwithSample(cfg).load_state_dict(got, strict=True)
    if variant == "metaformer_lstm":
        ref_mf.RefMetaformer().load_state_dict(got, strict=True)


def test_unmapped_names_raise():
    """A name no prefix covers on a name boundary, and a covered name
    whose leaf is of no known kind, are skipped on import, as the JAX
    importer skips them (``convert_checkpoint``'s strict load still
    refuses a parameter left out); export still raises for a name no
    table covers."""
    w = np.ones((2, 2), np.float32)
    assert import_torch_state_dict({"elsewhere.weight": w}, {"x": "y"}) == {}
    # a prefix matches on a name boundary only: x1 is not under x
    assert import_torch_state_dict({"x1.weight": w}, {"x": "y"}) == {}
    got = import_torch_state_dict(
        {"x.running_mean": np.zeros(2), "x.weight": w}, {"x": "y"})
    assert list(got) == ["y.weight"]
    ref, _, _, cfg = _lws_reference(8)
    sd = _numpy_sd(ref)
    clean = torch_import.import_lws_state_dict(sd, cfg)
    sd["extra.weight"] = np.zeros((2, 2), np.float32)
    extra = torch_import.import_lws_state_dict(sd, cfg)
    assert set(extra) == set(clean)
    assert all(torch.equal(extra[k], clean[k]) for k in clean)
    with pytest.raises(ValueError, match="no reference mapping"):
        torch_export.export_torch_state_dict(
            {"somewhere.weight": torch.zeros(2, 2)}, {"x": "y"})


@pytest.mark.parametrize("variant", ["metaformer_lstm", "lstm_with_sampling"])
def test_extra_entry_skipped_as_jax_skips_it(variant):
    """A reference state dict with one extra entry (``buffer.weight``,
    which no table covers, and a covered ``running_mean`` buffer): the
    JAX importer and the port's give the same parameters, bit for bit,
    and the port's loads with ``strict=True``."""
    model_type, make_ref, _, jax_import, port_import, _ = VARIANTS[variant]
    ref, _, _, cfg = make_ref(9)
    sd = _numpy_sd(ref)
    first = next(iter(sd)).rsplit(".", 1)[0]
    sd["buffer.weight"] = np.ones((3, 3), np.float32)
    sd[f"{first}.running_mean"] = np.ones(3, np.float32)
    want = state_dict_from_jax(flat_params(jax_import(sd, cfg)))
    got = port_import(sd, cfg)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    build_model(model_type, cfg, device="cpu").load_state_dict(
        got, strict=True)


def test_unpacked_qkv_round_trip():
    """MHA with kdim/vdim != embed_dim keeps q/k/v unpacked (bias packed),
    as the JAX export test holds it."""
    rng = np.random.default_rng(12)
    e, kdim = 8, 6
    shapes = {"q_proj_weight": (e, e), "k_proj_weight": (e, kdim),
              "v_proj_weight": (e, kdim), "q_proj_bias": (e,),
              "k_proj_bias": (e,), "v_proj_bias": (e,),
              "out_proj_weight": (e, e), "out_proj_bias": (e,)}
    port_sd = {f"att.{k}": torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}
    nm = {"block.cross_att": "att"}
    sd = torch_export.export_torch_state_dict(port_sd, nm)
    want = jexport.export_torch_state_dict(
        {"att": {k[4:]: v.numpy() for k, v in port_sd.items()}}, nm)
    assert set(sd) == set(want) and "block.cross_att.q_proj_weight" in sd
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), want[k])
    back = import_torch_state_dict(sd, nm)
    assert set(back) == set(port_sd)
    assert all(torch.equal(back[k], port_sd[k]) for k in port_sd)


def test_convert_checkpoint_and_the_file_entry_points(tmp_path):
    """A Lightning-style .ckpt ('model.'-prefixed state_dict and an epoch)
    through ``torch_import.main``, the port checkpoint it writes, and back
    out through ``torch_export.main``; a mismatched config raises."""
    ref, ref_y, xs, cfg = _lws_reference(9)
    lightning = {"state_dict": {f"model.{k}": v for k, v in
                                ref.state_dict().items()},
                 "epoch": 7, "hyper_parameters": {"note": "kept aside"}}
    ckpt = tmp_path / "ref.ckpt"
    torch.save(lightning, ckpt)
    yaml = tmp_path / "lws.yaml"
    yaml.write_text(
        "exp:\n  use_model: lstm_with_sampling\nmodel:\n"
        + "".join(f"  {k}: {str(v).lower() if isinstance(v, bool) else v}\n"
                  for k, v in cfg.items()))
    torch_import.main(["--config", str(yaml), "--ckpt", str(ckpt),
                       "--out", str(tmp_path / "imported")])
    payload = load_checkpoint(str(tmp_path / "imported" / "last"))
    assert payload["epoch"] == 7
    port = build_model("lstm_with_sampling", cfg, device="cpu")
    port.load_state_dict(payload["params"], strict=True)
    np.testing.assert_allclose(_port_forward(port, xs), ref_y.numpy(),
                               atol=2e-5)

    out = tmp_path / "exported.ckpt"
    torch_export.main(["--config", str(yaml), "--ckpt",
                       str(tmp_path / "imported" / "last"), "--out", str(out)])
    back = torch.load(out, map_location="cpu", weights_only=True)
    assert back["epoch"] == 7
    assert set(back["state_dict"]) == set(ref.state_dict())
    assert all(torch.equal(back["state_dict"][k], v)
               for k, v in ref.state_dict().items())

    with pytest.raises(ValueError, match="does not match"):
        torch_import.convert_checkpoint(
            "lstm_with_sampling", dict(cfg, hidden_size=32),
            _numpy_sd(ref), str(tmp_path / "x"))
