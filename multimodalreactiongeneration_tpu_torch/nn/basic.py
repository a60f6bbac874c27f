"""Basic blocks: nonlinearities, Dense, LayerNorm, FeedForward, residual,
and the refusal of dropout in training (not ported yet).

Counterpart of ``multimodalreactiongeneration_tpu/nn/basic.py``. Parameter
names follow the flax tree of the JAX package so a converted parameter
tree loads with ``strict=True`` (``models/weights.py``): a Dense is an
``nn.Linear`` (torch layout ``weight`` (out, in)), a LayerNorm holds
``weight``/``bias`` (flax ``scale``/``bias``).

LayerNorm uses the fast-variance form E[x^2] - mean^2 with eps 1e-5, as
flax and the JAX kernels do.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

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


def refuse_dropout(module: nn.Module) -> None:
    """Dropout in training comes with a later slice; until then a module
    that would apply it raises instead of silently skipping it."""
    if module.dropout > 0 and module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: dropout {module.dropout} in training "
            "is not ported yet (use dropout 0.0, or eval mode)"
        )


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
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


def dense(
    in_features: int,
    out_features: int,
    generator: torch.Generator,
    bias: bool = True,
) -> nn.Linear:
    """nn.Linear with flax's Dense init: lecun-normal (truncated normal,
    std sqrt(1/fan_in) / .8796) weight and zero bias."""
    lin = nn.Linear(in_features, out_features, bias=bias, device="meta")
    std = math.sqrt(1.0 / in_features) / 0.87962566103423978
    w = torch.empty(out_features, in_features)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    lin.weight = nn.Parameter(w)
    if bias:
        lin.bias = nn.Parameter(torch.zeros(out_features))
    return lin


class ResidualConnection(nn.Module):
    """y = LN(module(x, ...) + x); extra tuple outputs pass through."""

    def __init__(self, module: nn.Module, dim: int,
                 use_layer_norm: bool = True):
        super().__init__()
        self.module = module
        self.LayerNorm_0 = LayerNorm(dim) if use_layer_norm else None

    def forward(self, x, *args, **kwargs):
        y = self.module(x, *args, **kwargs)
        others = None
        if isinstance(y, (tuple, list)):
            others = tuple(y[1:])
            y = y[0]
        y = y + x
        if self.LayerNorm_0 is not None:
            y = self.LayerNorm_0(y)
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
