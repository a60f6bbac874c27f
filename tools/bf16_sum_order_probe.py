#!/usr/bin/env python3
"""How far the plain bf16 versions of the encoder stack (K1/K3/K4) and
the LSTM layer (K7) move when only their sums change order, on the CPU,
and on a CUDA card how far the kernels' bf16 modes sit from them.

    python3 tools/bf16_sum_order_probe.py [--card]

For each shape it runs the plain bf16 version twice, once as it is and
once with every f32 matrix product summed in f64 (then rounded to f32),
and prints, over the first 1, 2, 4 and 16 steps and the whole length,
the mean distance between the two outputs over the mean distance between
the plain bf16 and the plain f32 outputs. A bf16 kernel sums in another
order than the plain version, so a rounding boundary can flip between
them; these readings say how much of the distance tests' bound
(``chip_smoke.BF16_MODE_FRAC``, a quarter) such flips take at each
window. Data from numpy seeds as in ``tests/test_torch_port_kernels.py``.

With ``--card`` everything runs on CUDA device 0 and each shape also
prints the kernel's bf16 mode (``kernel``) and, as the control a distance
test must fail, the f32 kernel on the same values (``f32_kernel``: f32
operands, so about 1), over the same windows.
"""
import argparse
import sys

import numpy as np
import torch

sys.path.insert(0, ".")

from multimodalreactiongeneration_tpu_torch.ops import (  # noqa: E402
    lstm_layer as K7,
    mixer_stack as K1,
)

STACKS = ((17, 33, 448, 2), (19, 37, 512, 2), (32, 96, 512, 5),
          (32, 252, 512, 5), (32, 252, 384, 5), (32, 252, 192, 5),
          (32, 252, 256, 5), (32, 252, 128, 5), (16, 40, 256, 3))
LAYERS = ((32, 252, 512), (32, 252, 384), (250, 17, 384), (256, 140, 256))


def seeded(seed, device):
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0, mean=0.0):
        x = mean + s * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.float32)).to(device)
    return r


def f64_sums(fn):
    """fn with every f32 x f32 matrix product summed in f64."""
    def run(*args):
        mm, op = torch.matmul, torch.Tensor.__matmul__

        def wide(a, b, f):
            if a.dtype == b.dtype == torch.float32:
                return f(a.double(), b.double()).float()
            return f(a, b)
        torch.matmul = lambda a, b: wide(a, b, mm)
        torch.Tensor.__matmul__ = lambda a, b: wide(a, b, op)
        try:
            return fn(*args)
        finally:
            torch.matmul, torch.Tensor.__matmul__ = mm, op
    return run


def report(name, plain, args, kernel=None):
    with torch.no_grad():
        y = plain(*args)
        y32 = plain(*[a.float() for a in args])
        others = {"f64_sums": f64_sums(plain)(*args)}
        if kernel is not None:
            others["kernel"] = kernel(*args)
            others["f32_kernel"] = kernel(*[a.float() for a in args])
    for n in (1, 2, 4, 16, None):
        w = slice(None) if n is None else slice(0, n)
        gap = float((y32[:, w] - y[:, w]).abs().mean())
        ratios = {k: float((v[:, w] - y[:, w]).abs().mean()) / gap
                  for k, v in others.items()}
        print(f"{name} steps={n or 'all'} " + " ".join(
            f"{k}_over_f32_gap={v:.4f}" for k, v in ratios.items()),
            flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--card", action="store_true")
    card = ap.parse_args().card
    device = "cuda:0" if card else "cpu"
    torch.set_num_threads(8)
    bf = torch.bfloat16
    for b, t, h, n in STACKS:
        r = seeded(b * t + h + n, device)
        args = [r(b, t, h), r(n, h, 4 * h, s=.06), r(n, 4 * h, s=.06),
                r(n, h, 4 * h, s=.06), r(n, h, h, s=.06), r(n, h, s=.1),
                r(n, h, s=.1, mean=1.), r(n, h, s=.1), r(n, h, s=.1, mean=1.),
                r(n, h, s=.1), r(n, b, h, s=.3), r(n, b, h, s=.3)]
        for i in K1._WEIGHTS:
            args[i] = args[i].to(bf)
        report(f"stack B{b} T{t} H{h} L{n}",
               lambda *a: K1.mixer_stack_forward_reference(*a)[0], args,
               (lambda *a: K1.mixer_stack_recurrence(*a)[0]) if card
               else None)
    for b, t, h in LAYERS:
        r = seeded(b * t + h, device)
        args = (r(b, t, h).to(bf), r(h, 4 * h, s=.06).to(bf),
                r(4 * h, s=.06), r(h, 4 * h, s=.06).to(bf), r(b, h, s=.3),
                r(b, h, s=.3))
        report(f"k7 B{b} T{t} H{h}",
               lambda *a: K7.lstm_layer_reference(*a)[0], args,
               (lambda *a: K7.lstm_layer(*a)[0]) if card else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
