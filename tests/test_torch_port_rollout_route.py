"""PyTorch port: where ``generate_metaformer``'s hoisted rollout goes
(``infer/generate.py _rollout_route``), decided from shapes before any
launch, with the device type as an argument so the card's choice is held
here.

JAX's ``fused_rollout="auto"`` never raises on a config its gate takes:
off the TPU it runs the scan, on the TPU its kernel where the kernel fits
and the scan elsewhere (JAX ``infer/generate.py``). The port's K2 takes
hidden 256 with 4 heads, rings up to 2048 slots and a bottleneck that is
a multiple of 64 (``ops/decode_rollout.py kernel_contract``). So on
CUDA "auto" sends a config that passes ``_fused_rollout_supported`` but
not K2's contract (hidden 128, 8 heads, a bottleneck of 32, rings over
2048 slots) to the module loop, and ``fused_rollout=True`` raises with
K2's reason; on the CPU nothing changes (the plain fused version takes
every supported config); a config outside the gate takes the loop under
"auto" and raises under True on either device.
"""

import pytest
import torch

from multimodalreactiongeneration_tpu_torch.configs import LSTMFORMER_MODEL_CFG
from multimodalreactiongeneration_tpu_torch.infer import generate as G
from multimodalreactiongeneration_tpu_torch.ops.decode_rollout import (
    kernel_contract,
)

FLAGSHIP = dict(LSTMFORMER_MODEL_CFG)
RATIO, LEN_A0 = 8, 96
OUTSIDE_K2 = {  # each passes _fused_rollout_supported; K2 refuses it
    "hidden128": (dict(FLAGSHIP, hidden_size=128), "hidden 256"),
    "heads8": (dict(FLAGSHIP, num_heads=8), "4 heads"),
    "bottleneck32": (dict(FLAGSHIP, bottleneck_size=32), "multiple of 64"),
    "ring4000": (dict(FLAGSHIP, max_context_len=40), "2048 slots"),
}


def _route(cfg, fused, device, dtype=torch.bfloat16):
    return G._rollout_route(cfg, dtype, fused, device, RATIO, LEN_A0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flagship_takes_the_kernel_everywhere(dtype):
    assert G._fused_rollout_supported(FLAGSHIP, dtype, RATIO, LEN_A0)
    for fused in ("auto", True):
        assert _route(FLAGSHIP, fused, "cuda", dtype)
        assert _route(FLAGSHIP, fused, "cpu", dtype)
    assert not _route(FLAGSHIP, False, "cuda", dtype)


@pytest.mark.parametrize("name", sorted(OUTSIDE_K2))
def test_auto_on_cuda_takes_the_loop_outside_k2(name):
    cfg, why = OUTSIDE_K2[name]
    assert G._fused_rollout_supported(cfg, torch.bfloat16, RATIO, LEN_A0)
    assert not _route(cfg, "auto", "cuda")
    assert not _route(cfg, False, "cuda")
    with pytest.raises(ValueError, match=why):
        _route(cfg, True, "cuda")
    # the CPU's plain fused version takes every supported config
    assert _route(cfg, "auto", "cpu") and _route(cfg, True, "cpu")


def test_config_outside_the_gate():
    cfg = dict(FLAGSHIP, interlayer_residual=True)
    assert not G._fused_rollout_supported(cfg, torch.bfloat16, RATIO, LEN_A0)
    for device in ("cpu", "cuda"):
        assert not _route(cfg, "auto", device)
        with pytest.raises(ValueError, match="fused_rollout"):
            _route(cfg, True, device)


def test_kernel_contract_names_each_refusal():
    ok = (256, 4, 1000, 125, 125, 64, 8, 96)
    assert kernel_contract(*ok) is None
    for i, value, why in ((0, 128, "hidden 256"), (1, 8, "4 heads"),
                          (2, 4000, "2048 slots"), (4, 126, "bud_m 126"),
                          (5, 32, "multiple of 64"),
                          (2, 1004, "ratio multiples"),
                          (7, 100, "ratio multiples")):
        args = list(ok)
        args[i] = value
        assert why in kernel_contract(*args)


def test_generate_on_cpu_keeps_the_plain_fused_version(monkeypatch):
    """A hidden-128 Metaformer (outside K2) on the CPU under "auto" still
    runs decode_rollout's plain version, once."""
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )
    from multimodalreactiongeneration_tpu_torch.ops import decode_rollout
    from tests.test_streaming_models import MF_CFG
    from tests.test_torch_port_weights import np_batch

    calls = []
    real = decode_rollout.decode_rollout
    monkeypatch.setattr(decode_rollout, "decode_rollout",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    pm = Metaformer(dict(MF_CFG, hidden_size=128),
                    generator=torch.Generator().manual_seed(0), device="cpu")
    batch = [torch.from_numpy(x) for x in np_batch(0)]
    out = G.generate_metaformer(pm, batch, torch.zeros(6, dtype=torch.bool))
    assert out.shape == (2, 6, 18) and calls == [1]
