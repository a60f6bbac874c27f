"""Basic blocks: nonlinearities, Dense, LayerNorm, FeedForward, residual,
and dropout.

Counterpart of ``multimodalreactiongeneration_tpu/nn/basic.py``. Parameter
names follow the flax tree of the JAX package so a converted parameter
tree loads with ``strict=True`` (``models/weights.py``): a Dense is an
``nn.Linear`` (torch layout ``weight`` (out, in)), a LayerNorm holds
``weight``/``bias`` (flax ``scale``/``bias``).

LayerNorm uses the fast-variance form E[x^2] - mean^2 with eps 1e-5, as
flax and the JAX kernels do; on bf16 input (the bf16 training step) it
computes in f32 and returns bf16, as flax's does. Dense layers, ReLU,
residuals and dropout run in their inputs' dtype, as flax's. Where an
f32 activation meets a bf16 parameter (the bf16 step's later Metaformer
blocks), every op gives the dtype ``jnp`` promotion gives: elementwise
ops promote by themselves; ``matmul`` and ``Dense`` compute such a pair
in f32 on the bf16 values converted exactly, as ``jnp.einsum`` and
flax's ``Dense`` do.

Dropout is flax's ``nn.Dropout``: in training each element is kept with
probability 1 - p and scaled by 1 / (1 - p), else zeroed; in eval mode it
is the identity. The masks come from no global generator: a training
step runs its forward inside ``dropout_rng(seed)``, with the seed drawn
from the trainer's ``torch.Generator``, and every mask of that forward is
drawn, in the order the modules draw them, from generators seeded with
it (one per device). So the same seed gives the same masks, and a
recompute under ``torch.utils.checkpoint`` that re-enters
``dropout_rng`` with the step's seed draws the forward's masks again
(JAX's remat reuses its dropout key the same way).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Optional

import torch
from torch import nn

LN_EPS = 1e-5


def set_nonlinearity(name: Optional[str]) -> Optional[Callable]:
    if name is None or name == "none":
        return None
    table = {
        "relu": torch.relu,
        "swish": torch.nn.functional.silu,
        "silu": torch.nn.functional.silu,
        "tanh": torch.tanh,
    }
    if name not in table:
        raise ValueError(f"unknown nonlinearity {name!r}")
    return table[name]


# the seeds of the forwards running inside dropout_rng, innermost last,
# each with its generators by device
_DROPOUT_RNG: List[Dict] = []


@contextlib.contextmanager
def dropout_rng(seed: Optional[int]) -> Iterator[None]:
    """Draw the dropout masks of the forward run inside from generators
    seeded with ``seed`` (None: none, as outside)."""
    if seed is None:
        yield
        return
    _DROPOUT_RNG.append({"seed": int(seed), "generators": {}})
    try:
        yield
    finally:
        _DROPOUT_RNG.pop()


def dropout(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    """flax ``nn.Dropout(p)`` (``deterministic = not training``)."""
    if p <= 0 or not training:
        return x
    if not _DROPOUT_RNG:
        raise RuntimeError(
            f"dropout {p} in training draws its masks inside "
            "nn.basic.dropout_rng(seed); the train steps enter it with a "
            "seed from the generator they are given (train_step(batch, "
            "generator))")
    rng = _DROPOUT_RNG[-1]
    gen = rng["generators"].get(x.device)
    if gen is None:
        gen = torch.Generator(device=x.device).manual_seed(rng["seed"])
        rng["generators"][x.device] = gen
    keep_prob = 1.0 - p
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    if x.dtype != torch.float32:
        # flax's LayerNorm on bf16: the statistics and the affine map in
        # f32 (the variance clipped at 0), the output in x's dtype. x is
        # converted twice, as flax converts it (once for the statistics,
        # once where x - mean promotes), so the backward rounds each
        # conversion's cotangent to bf16 and sums the two in bf16 as JAX
        xs = x.float()
        mu = xs.mean(-1, keepdim=True)
        var = ((xs * xs).mean(-1, keepdim=True) - mu * mu).clamp(min=0.0)
        y = (x.float() - mu) * (torch.rsqrt(var + LN_EPS) * weight.float())
        return (y + bias.float()).to(x.dtype)
    mu = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    return (x - mu) * torch.rsqrt(var + LN_EPS) * weight + bias


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


def promote(a: torch.Tensor, b: torch.Tensor):
    """``a``, ``b`` in ``jnp`` promotion: a pair of one dtype as it is; a
    mixed pair (an f32 activation with a bf16 weight) in the promoted
    dtype, the narrower operand converted exactly."""
    if a.dtype != b.dtype:
        dtype = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dtype), b.to(dtype)
    return a, b


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in ``jnp`` promotion (``promote``)."""
    a, b = promote(a, b)
    return a @ b


class Dense(nn.Linear):
    """nn.Linear that rounds as flax's Dense: on bf16 input with bf16
    parameters the product is rounded to bf16, then the bias add (torch's
    fused add rounds once); input and parameters of two dtypes promote to
    the wider (flax's ``promote_dtype``); f32 throughout takes
    nn.Linear's own forward."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != self.weight.dtype:
            dtype = torch.promote_types(x.dtype, self.weight.dtype)
            bias = None if self.bias is None else self.bias.to(dtype)
            return nn.functional.linear(x.to(dtype), self.weight.to(dtype),
                                        bias)
        if x.dtype == torch.float32 or self.bias is None:
            return super().forward(x)
        return nn.functional.linear(x, self.weight) + self.bias


def dense(
    in_features: int,
    out_features: int,
    generator: torch.Generator,
    bias: bool = True,
) -> nn.Linear:
    """``Dense`` with flax's Dense init: lecun-normal (truncated normal,
    std sqrt(1/fan_in) / .8796) weight and zero bias."""
    lin = Dense(in_features, out_features, bias=bias, device="meta")
    std = math.sqrt(1.0 / in_features) / 0.87962566103423978
    w = torch.empty(out_features, in_features)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    lin.weight = nn.Parameter(w)
    if bias:
        lin.bias = nn.Parameter(torch.zeros(out_features))
    return lin


class ResidualConnection(nn.Module):
    """y = dropout(LN(module(x, ...) + x)); extra tuple outputs pass
    through."""

    def __init__(self, module: nn.Module, dim: int,
                 use_layer_norm: bool = True, dropout: float = 0.0):
        super().__init__()
        self.module = module
        self.LayerNorm_0 = LayerNorm(dim) if use_layer_norm else None
        self.dropout = dropout

    def forward(self, x, *args, **kwargs):
        y = self.module(x, *args, **kwargs)
        others = None
        if isinstance(y, (tuple, list)):
            others = tuple(y[1:])
            y = y[0]
        y = y + x
        if self.LayerNorm_0 is not None:
            y = self.LayerNorm_0(y)
        y = dropout(y, self.dropout, self.training)
        if others is not None:
            return (y, *others)
        return y


class FeedForward(nn.Module):
    """Linear or Linear-act-Linear with optional residual+LN wrap."""

    def __init__(
        self,
        hidden_size: int,
        generator: torch.Generator,
        bottleneck_size: Optional[int] = None,
        output_size: Optional[int] = None,
        nonlinearity: Optional[str] = None,
        residual: bool = False,
        residual_layer_norm: bool = False,
        use_bias: bool = True,
    ):
        super().__init__()
        bottleneck = hidden_size if bottleneck_size is None else bottleneck_size
        out_size = hidden_size if output_size is None else output_size
        if residual and hidden_size != out_size:
            raise ValueError(
                "hidden_size must equal output_size when residual is True"
            )
        self.act = set_nonlinearity(nonlinearity)
        self.residual = residual
        if self.act is None:
            self.feedforward = dense(hidden_size, out_size, generator,
                                     use_bias)
        else:
            self.input = dense(hidden_size, bottleneck, generator, use_bias)
            self.output = dense(bottleneck, out_size, generator, use_bias)
        self.LayerNorm_0 = (
            LayerNorm(out_size) if residual and residual_layer_norm else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act is None:
            y = self.feedforward(x)
        else:
            y = self.output(self.act(self.input(x)))
        if self.residual:
            y = y + x
            if self.LayerNorm_0 is not None:
                y = self.LayerNorm_0(y)
        return y
