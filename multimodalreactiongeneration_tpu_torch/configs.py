"""Model configurations as plain dicts (no yaml at run time).

``LSTMFORMER_MODEL_CFG`` is the resolved ``model:`` group of
``configs/lstmformer.yaml`` restricted to the keys the model reads: the
flagship Metaformer at the production size (hidden 256, 5 blocks, LSTM
embeddings, encoders of 5 mixer blocks, 4-head integrators, 10 s context
budget). ``LSTMFORMER_LOSS_CFG``, ``LSTMFORMER_METRICS_CFG`` and
``LSTMFORMER_OPTIM_CFG`` are what the training step reads from the same
file. The tests hold all four equal to the yaml as the JAX config loader
resolves it.
"""

LSTMFORMER_MODEL_CFG = dict(
    main_modal_idx=2,
    hidden_size=256,
    num_block=5,
    dropout=0.0,
    num_layerd=1,
    encoder_num_layer=5,
    num_internal_layer=1,
    residual=True,
    residual_layer_norm=True,
    bias=True,
    emb_mixers=["lstm", "lstm", "lstm"],
    bottleneck_size=64,
    nonlinearity="none",
    ffn_nonlinearity="relu",
    proj_size=0,
    num_heads=4,
    add_bias_kv=False,
    add_zero_attn=False,
    max_context_len=10,
    repeat_with_encoder=False,
    interlayer_residual=False,
    interlayer_residual_norm=True,
    sampling_rate=16000,
    shift=160,
    pred_fps=12.5,
    modalities=["audio", "motion", "motion"],
    use_centroid=True,
    use_angle=True,
    nmels=26,
    delta_order=2,
)

# the loss keys of the same ``model:`` group, which the training step
# reads beside the model's own
LSTMFORMER_LOSS_CFG = dict(
    loss_type="huber",
    loss_reduction="mean",
    huber_delta=1.0,
    smoothl1_beta=1.0,
    delta_loss_scale=1,
)

# the ``metrics:`` and ``optim:`` groups of ``configs/lstmformer.yaml``
LSTMFORMER_METRICS_CFG = dict(use_centroid=True, use_angle=True,
                              delta_order=2)
LSTMFORMER_OPTIM_CFG = dict(use_optimizer="adam", momentum=0.9,
                            weight_decay=1e-2, lr=5e-6)
