"""PyTorch port: each CUDA kernel vs its plain PyTorch version, on a card.

Marked ``cuda``; every test skips without a CUDA device (the kernels
have no CPU mode). The file imports no JAX, so it also runs on a machine
without it: ``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_port_kernels.py -q``. Tolerances: f32 kernel vs f32
plain version 1e-4 (sums in another order through a long recurrence).
"""

import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu_torch.ops import (
    decode_rollout as K2,
    mixer_stack as K1,
)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,t,layers", [(16, 40, 3), (3, 17, 2), (20, 33, 5)])
def test_mixer_stack_kernel_matches_plain(dev, b, t, layers):
    h = 256
    rng = np.random.default_rng(b * t)

    def r(*shape, s=1.0, mean=0.0):
        x = mean + s * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    n = layers
    args = (r(b, t, h), r(n, h, 4 * h, s=0.06), r(n, 4 * h, s=0.06),
            r(n, h, 4 * h, s=0.06), r(n, h, h, s=0.06), r(n, h, s=0.1),
            r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
            r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
            r(n, b, h, s=0.3), r(n, b, h, s=0.3))
    before = K1.launches
    y, (hn, cn) = K1.mixer_stack_forward(*args)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    yr, (hr, cr) = K1.mixer_stack_forward_reference(*args)
    for got, want in ((y, yr), (hn, hr), (cn, cr)):
        assert float((got - want).abs().max()) <= TOL


def test_mixer_stack_kernel_refuses_bf16_weights(dev):
    x = torch.zeros(2, 16, 256, device=dev)
    w = torch.zeros(1, 256, 1024, device=dev, dtype=torch.bfloat16)
    z = torch.zeros(1, 256, device=dev)
    s = torch.zeros(1, 2, 256, device=dev)
    with pytest.raises(ValueError, match="f32"):
        K1.mixer_stack_forward(x, w, torch.zeros(1, 1024, device=dev), w,
                               torch.zeros(1, 256, 256, device=dev), z, z, z,
                               z, z, s, s)


@pytest.mark.parametrize("batch", [16, 18])
@pytest.mark.parametrize("mode", ["teacher", "full"])
def test_decode_rollout_kernel_matches_plain(dev, batch, mode):
    from multimodalreactiongeneration_tpu_torch.configs import (
        LSTMFORMER_MODEL_CFG,
    )
    from multimodalreactiongeneration_tpu_torch.infer import generate as G
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )

    model = Metaformer(LSTMFORMER_MODEL_CFG,
                       generator=torch.Generator().manual_seed(0), device=dev)
    frames, lead, ratio = 6, 12, 8
    rng = np.random.default_rng(batch)
    shapes = [(batch, frames * ratio, 81), (batch, frames, 18),
              (batch, frames, 18), (batch, lead * ratio, 81),
              (batch, lead, 18), (batch, lead, 18), (batch, frames, 18)]
    data = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev) for s in shapes]
    mask = G.sampling_mask_for(frames, mode, device=dev)
    with torch.no_grad():
        states, ea, em, ms, la, lm = G._hoist_and_warmup(
            model, data, torch.float32)
        args, kw = G._fused_rollout_args(
            model, states, ea, em, ms, mask, torch.float32, la, lm)
        before = K2.launches
        got = K2.decode_rollout(*args, **kw)
        torch.cuda.synchronize()
        assert K2.launches == before + (batch + 15) // 16
        want = K2.decode_rollout_reference(*args, **kw)
    assert float((got - want).abs().max()) <= TOL
