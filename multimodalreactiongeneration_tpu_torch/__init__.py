"""PyTorch/CUDA port of the multimodal reaction generation framework.

Mirrors the layout of the JAX package ``multimodalreactiongeneration_tpu``
(``ops/``, ``nn/``, ``models/``, ``infer/``) so each module's counterpart
sits at the same path. Imports only ``torch``, ``numpy`` and the standard
library. The hand-written Hopper kernels live in ``csrc/`` and are built
with ``nvcc`` at first use (``_build.py``); every kernel wrapper keeps a
plain PyTorch version beside it, which it runs for CPU tensors only.

Entry points (the model, the loaders, the trainer, the training CLI, the
corpus tools and their CLIs) run on ``cuda:0`` unless the caller names a
device: ``resolve_device``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when the caller names
    one, else ``cuda:0``; with no device named and no CUDA it raises
    rather than run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on cuda:0 unless the caller "
            "names a device (pass device='cpu' to run on the CPU)"
        )
    return torch.device("cuda", 0)

