#!/usr/bin/env python3
"""Where one LeNet-5 training step of the PyTorch port spends its time
on the card.

    python3 scripts/torch_train_profile.py [--steps 20] [--batch 256]

Trains full-width LeNet-5 (``zoo.lenet()``: Adam, MCXENT) on synthetic
MNIST through ``MultiLayerNetwork.fit_minibatch`` on one CUDA card:
a few warm-up steps, ``--steps`` steps timed on the host clock, then
the same number under ``torch.profiler`` (CPU and CUDA activities).
Prints the card line, the host-clock time of a step without and with
the profiler, the device time of a step (the sum of the traced device
activities' own times: kernels and copies), the device's busy share,
the device activities per step, and the device time of every kernel,
largest first. Needs a CUDA device; exits non-zero without one, and when the trace
holds no device time.
"""

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the hand-written kernels, by the symbol names their launches carry
OURS = ("conv_block_kernel", "conv_bwd_data_kernel", "conv_bwd_w_kernel",
        "matmul_block_kernel", "splitk_finish_kernel")


def device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--warmup", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device is available",
              file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import lenet

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n = args.warmup + 2 * args.steps
    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        batches = list(MnistDataSetIterator(
            args.batch, num_examples=args.batch * n, allow_synthetic=True))
    net = MultiLayerNetwork(lenet(), device="cuda").init()
    for ds in batches[:args.warmup]:
        net.fit_minibatch(ds)
    timed = batches[args.warmup:args.warmup + args.steps]
    traced = batches[args.warmup + args.steps:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ds in timed:
        net.fit_minibatch(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for ds in traced:
            net.fit_minibatch(ds)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        us = device_us(evt)
        # device activities only: a CPU op's row repeats its kernels' time
        if us <= 0.0 or evt.device_type != DeviceType.CUDA:
            continue
        rows.append({"name": evt.key, "device_us_per_step": us / args.steps,
                     "calls_per_step": evt.count / args.steps,
                     "ours": any(k in evt.key for k in OURS)})
    rows.sort(key=lambda r: -r["device_us_per_step"])
    device_ms = sum(r["device_us_per_step"] for r in rows) / 1e3
    if device_ms <= 0.0:
        print("torch_train_profile: the trace holds no device time",
              file=sys.stderr)
        return 3
    ms_per_step = wall / args.steps * 1e3
    ours_ms = sum(r["device_us_per_step"] for r in rows if r["ours"]) / 1e3
    res = {"card": card, "batch": args.batch, "steps": args.steps,
           "ms_per_step": ms_per_step,
           "ms_per_step_profiled": traced_wall / args.steps * 1e3,
           "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / ms_per_step,
           "hand_written_kernels_ms_per_step": ours_ms,
           "device_activities_per_step": sum(r["calls_per_step"]
                                             for r in rows),
           "examples_per_s": args.batch / ms_per_step * 1e3}
    for r in rows:
        print(f"{r['device_us_per_step']:9.2f} us  {r['calls_per_step']:5.1f}x"
              f"  {'*' if r['ours'] else ' '} {r['name'][:90]}")
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
