#!/usr/bin/env python3
"""How fast a bf16 rounding flip compounds along the recurrences K10 and
K8, in their plain bf16 versions (CPU or card).

For each shape of ``chip_smoke.py`` phase 29b, the plain bf16 version's
ys on inputs moved by one f32 ulp (``xw`` to its next float up) against
its ys on the inputs as drawn, as a share of the plain f32 version's
distance from the plain bf16 ys (the distance test of ``bf16_check``),
over the first 4, 16, 64, 252 and 2016 steps. A faithful bf16 kernel
rounds at the same points but sums in another order, so its reading
grows as this one does; a kernel that took f32 operands reads ~1 at any
window. Run from the root of a checkout:

    python3 tools/bf16_chaos_probe.py [cpu|cuda]

One JSON line per shape.
"""
import json
import sys

import numpy as np
import torch

sys.path.insert(0, ".")

SHAPES = (("gru", 32, 2016, 256), ("gru", 32, 252, 256),
          ("gru", 128, 252, 256), ("lstm_recurrence", 256, 120, 128),
          ("lstm_recurrence", 32, 252, 256))
WINDOWS = (4, 16, 64, 252, 2016)


def main(device):
    from multimodalreactiongeneration_tpu_torch.ops import gru as K10
    from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as K8

    torch.set_num_threads(2)
    for kind, b, t, h in SHAPES:
        rng = np.random.default_rng(0)

        def r(*shape, s=1.0):
            return torch.from_numpy(
                (s * rng.standard_normal(shape)).astype(np.float32)).to(device)

        if kind == "gru":
            args = [r(b, t, 3 * h, s=.5), r(h, 3 * h, s=.06).bfloat16(),
                    r(3 * h, s=.1), r(b, h, s=.3)]
            plain = lambda a: K10.gru_recurrence_reference(*a)[0]
        else:
            args = [r(b, t, 4 * h, s=.5), r(h, 4 * h, s=.06).bfloat16(),
                    r(b, h, s=.3), r(b, h, s=.3)]
            plain = lambda a: K8.lstm_recurrence_reference(*a)[0]
        with torch.no_grad():
            ys = plain(args)
            ys32 = plain([a.float() for a in args])
            moved = plain([torch.nextafter(
                args[0], torch.tensor(np.inf, device=device)), *args[1:]])
        read = {}
        for w in WINDOWS:
            if w <= t:
                gap = float((ys32[:, :w] - ys[:, :w]).abs().mean())
                read[w] = float((moved[:, :w] - ys[:, :w]).abs().mean()) / gap
        print(json.dumps(dict(kernel=kind, B=b, T=t, H=h, device=device,
                              moved_over_f32_gap=read)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cpu")
