#!/usr/bin/env python3
"""The bf16 step's loss on a mesh with a data axis, against one process,
over several seeds, on the CPU (gloo ranks spawned by
``parallel/multihost_dryrun.py``).

For each mesh and each seed (the dryrun model's weights and global
batches), three bf16 steps and three f32 steps run on the ranks and in
one process; it prints one JSON line a mesh, variant and seed with each
step's relative loss difference (step k's loss is taken before its
update, so step 1's reads the parameters as they were drawn). The (4, 1)
mesh splits the rows as (2, 2) does with no model axis: where both read
alike, the difference comes from the data axis's mean, not from the
sharding.

    python3 tools/mesh_bf16_seeds.py [--seeds 0,1,2] [--meshes 2x2,4x1]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from multimodalreactiongeneration_tpu_torch.parallel import (  # noqa: E402
    multihost_dryrun as dryrun,
)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--meshes", default="2x2,4x1")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    seeds = [int(x) for x in args.seeds.split(",")]
    for shape in args.meshes.split(","):
        mesh = [int(x) for x in shape.split("x")]
        requests = [dryrun.step_request(("f32", "bf16"), mesh,
                                        steps=args.steps, tag=f"s{seed}",
                                        seed=seed) for seed in seeds]
        got = dryrun.readings(requests, mesh[0] * mesh[1], timeout=600.0)
        for seed, by_variant in zip(seeds, got):
            for variant, r in by_variant.items():
                rel = [max(abs(ranks[k] - r["single"][k])
                           for ranks in r["ranks"]) / abs(r["single"][k])
                       for k in range(args.steps)]
                print(json.dumps({"mesh": mesh, "variant": variant,
                                  "seed": seed, "loss_rel_err": rel,
                                  "param_err": r["param_err"]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
