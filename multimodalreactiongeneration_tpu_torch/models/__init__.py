"""Model registry: counterpart of the JAX package's ``models/__init__.py``
(reference mr_gen/model/model_loader.py:10-26)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from multimodalreactiongeneration_tpu_torch.models.lstm_with_sampling import (
    LSTMwithSample,
)
from multimodalreactiongeneration_tpu_torch.models.lstmformer import Metaformer
from multimodalreactiongeneration_tpu_torch.models.simple_lstm import SimpleLSTM

MODEL_TYPE = {"lstmformer": Metaformer, "lstm_with_sampling": LSTMwithSample,
              "simple_lstm": SimpleLSTM}


def build_model(model_type: str, model_cfg: Dict[str, Any],
                generator: Optional[torch.Generator] = None,
                device: Optional[torch.device] = None) -> torch.nn.Module:
    """The model named ``model_type`` from its config group, with weights
    drawn from ``generator``, on ``device`` (``cuda:0`` unless named)."""
    if model_type not in MODEL_TYPE:
        raise ValueError(
            f"model_type must be one of {sorted(MODEL_TYPE)}, got "
            f"{model_type!r}")
    cfg = (model_cfg.to_dict() if hasattr(model_cfg, "to_dict")
           else dict(model_cfg))
    return MODEL_TYPE[model_type](cfg, generator=generator, device=device)
