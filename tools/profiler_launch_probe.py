#!/usr/bin/env python3
"""Host time of a small kernel launch before and after torch.profiler
sessions in the same process, on one CUDA card.

    python3 tools/profiler_launch_probe.py [cpu+cuda|cuda|cpu]

Times 5,000 in-place adds on a 256-float tensor (best of three means, µs a
launch, host clock to a synchronize), then runs eight one-launch profiler
sessions with the given activities (default both), timing again after
each and counting the device events each session recorded. Prints one
JSON line with the times, the counts and the card's name and power
limit.
"""

import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ACTIVITIES = {"cpu+cuda": [ProfilerActivity.CPU, ProfilerActivity.CUDA],
              "cuda": [ProfilerActivity.CUDA],
              "cpu": [ProfilerActivity.CPU]}


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "cpu+cuda"
    x = torch.zeros(256, device="cuda")

    def launch_us(n=5000):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            x.add_(1.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e6

    def best():
        return min(launch_us() for _ in range(3))

    launch_us()  # warm-up
    times, device_events = [best()], []
    for _ in range(8):
        with profile(activities=ACTIVITIES[mode]) as prof:
            x.add_(1.0)
            torch.cuda.synchronize()
        device_events.append(sum(e.device_type == DeviceType.CUDA
                                 for e in prof.events()))
        times.append(best())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"activities": mode, "launch_us_after_sessions": {
        str(i): t for i, t in enumerate(times)},
        "device_events_per_session": device_events, "card": card}),
        flush=True)


if __name__ == "__main__":
    main()
