#!/usr/bin/env python3
"""How many of a profiled window's first GPU records Kineto keeps, by the
age of the process's CUPTI session.

    python3 tools/profile_torch_kineto_drift.py [--seconds 180] [--every 10]

One CUDA graph of 17 kernels (8 fp32 2048x2048 matmuls, 8 scalings, one
sum) is replayed under a ``torch.profiler`` window that starts just
before the replay, every `--every` seconds for `--seconds` seconds of
replays, and once more with a 50 ms lead-in between the window's start
and the replay (what ``ProfilerState.READY`` and ``ProfileCapture``'s
lead-in step give). Each window reports the kernels its trace holds and
the first kept kernel's distance from its graph launch. Kineto drops the
GPU records it stamps before a window's start; when its GPU clock runs
ahead of the host's, a window's first kernels go. Writes
``chiprun_out/profile_torch_kineto_drift.json``; needs one card.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

OUT = os.path.abspath("chiprun_out")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=180.0)
    ap.add_argument("--every", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    x = torch.randn(2048, 2048, device="cuda")

    def fn():
        y = x
        for _ in range(8):
            y = (y @ x) * 1e-3
        return y.sum()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp()
    t0 = time.monotonic()

    def window(lead_s=0.0):
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA], acc_events=True)
        prof.start()
        if lead_s:
            time.sleep(lead_s)
        graph.replay()
        torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(tmp, "w.json")
        prof.export_chrome_trace(path)
        evs = json.load(open(path))["traceEvents"]
        os.remove(path)
        ks = sorted(e["ts"] for e in evs if e.get("cat") == "kernel")
        launch = [e["ts"] for e in evs if e.get("name") == "cudaGraphLaunch"]
        return dict(
            age_s=time.monotonic() - t0, lead_s=lead_s, kernels=len(ks),
            first_kernel_after_launch_us=(ks[0] - launch[0]
                                          if ks and launch else None))

    rows = [window()]
    end = time.monotonic() + args.seconds
    next_at = time.monotonic() + args.every
    while time.monotonic() < end:
        graph.replay()
        torch.cuda.synchronize()
        if time.monotonic() >= next_at:
            rows.append(window())
            next_at += args.every
    rows.append(window(lead_s=0.05))
    for r in rows:
        print(f"kineto drift: age {r['age_s']:.1f} s, lead-in "
              f"{1e3 * r['lead_s']:.0f} ms: {r['kernels']} of 17 kernels "
              f"kept, the first {r['first_kernel_after_launch_us']} us after "
              f"its launch [{card}]", flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "profile_torch_kineto_drift.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__, rows=rows), f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
