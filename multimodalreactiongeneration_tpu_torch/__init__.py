"""PyTorch/CUDA port of the multimodal reaction generation framework.

Mirrors the layout of the JAX package ``multimodalreactiongeneration_tpu``
(``ops/``, ``nn/``, ``models/``, ``infer/``) so each module's counterpart
sits at the same path. Imports only ``torch``, ``numpy`` and the standard
library. The hand-written Hopper kernels live in ``csrc/`` and are built
with ``nvcc`` at first use (``_build.py``); every kernel wrapper keeps a
plain PyTorch version beside it, which it runs for CPU tensors only.
"""
