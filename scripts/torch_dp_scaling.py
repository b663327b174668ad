#!/usr/bin/env python3
"""Data-parallel scaling of the port's ``DistributedTrainer`` over the
cards of one host: ResNet-50 at 224 x 224 x 3, 1000 classes, f32,
NESTEROVS lr 0.01, ``batch_stats="sync"``, ``--batch`` rows a rank
(weak scaling: the global batch grows with the ranks), on synthetic
uint8 pixels from a seed.

    python3 scripts/torch_dp_scaling.py --world 4 [--batch 128] [--steps 5]

Runs a world of one, then a world of ``--world``: each a set of
processes, one a card, joined over NCCL through a file rendezvous in a
temporary directory. Each rank takes the same global minibatches, runs
2 warm-up steps and ``--steps`` timed ones (host clock, synchronised a
step), and checks that its weights after the run equal rank 0's bit
for bit. Prints one JSON line a world (the slowest rank's median step,
examples/s) and one with the weak-scaling efficiency (examples/s at the
world over the world times examples/s of one) and the card's name and
power limit. ``--device cpu --tiny`` runs the same path over gloo with
a small ResNet, to rehearse it without a card. Exits non-zero without a
card unless ``--device cpu``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def rank_main(args) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import (
        DistributedTrainer,
        build_mesh,
        init_distributed,
        shutdown_distributed,
    )
    from deeplearning4j_tpu_torch.zoo import resnet50

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = init_distributed(f"file://{args.rdv}", args.world, args.rank,
                           device=args.device, timeout_s=300)
    try:
        if args.tiny:
            conf = resnet50(height=32, width=32, channels=3, n_classes=10,
                            depths=(1, 1), base_width=8,
                            learning_rate=0.01)
            side, classes = 32, 10
        else:
            conf = resnet50(learning_rate=0.01)
            side, classes = 224, 1000
        net = ComputationGraph(conf, device=dev).init()
        tr = DistributedTrainer(net, mesh=build_mesh(), batch_stats="sync")
        rows = args.batch * args.world
        rng = np.random.RandomState(0)
        data = [DataSet(rng.randint(0, 256, (rows, 3, side, side),
                                    dtype=np.uint8),
                        np.eye(classes, dtype=np.uint8)[
                            rng.randint(0, classes, rows)])
                for _ in range(2)]

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize()

        for i in range(2):
            tr.fit_minibatch(data[i % 2])
        sync()
        times = []
        for i in range(args.steps):
            t0 = time.perf_counter()
            score = float(tr.fit_minibatch(data[i % 2]))
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        # the replicas stay identical: every rank's weights equal rank 0's
        flat = torch.cat([t.reshape(-1) for lp in net.params.values()
                          for t in lp.values()])
        ref = flat.clone()
        dist.broadcast(ref, src=0)
        same = bool(torch.equal(flat, ref))
        with open(args.out, "w") as f:
            json.dump({"rank": args.rank, "ms": times, "score": score,
                       "same_as_rank0": same}, f)
    finally:
        shutdown_distributed()
    return 0


def run_world(args, world: int) -> dict:
    tmp = tempfile.mkdtemp(prefix="dl4j_dp_")
    procs = []
    for r in range(world):
        cmd = [sys.executable, os.path.abspath(__file__), "--rank", str(r),
               "--world", str(world), "--rdv", os.path.join(tmp, "rdv"),
               "--out", os.path.join(tmp, f"rank{r}.json"),
               "--batch", str(args.batch), "--steps", str(args.steps),
               "--device", args.device] + (["--tiny"] if args.tiny else [])
        procs.append(subprocess.Popen(cmd, cwd=HERE))
    try:
        for p in procs:
            p.wait(timeout=1200)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"world {world}: a rank failed "
                           f"{[p.returncode for p in procs]}")
    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if not all(r["same_as_rank0"] for r in ranks):
        raise RuntimeError(f"world {world}: the replicas differ")
    # a step ends when its slowest rank ends
    step_ms = [max(r["ms"][i] for r in ranks) for i in range(args.steps)]
    ms = statistics.median(step_ms)
    res = {"world": world, "batch_per_rank": args.batch,
           "global_batch": args.batch * world, "step_ms": step_ms,
           "median_step_ms": ms,
           "examples_per_s": args.batch * world / ms * 1e3,
           "score": ranks[0]["score"]}
    print(json.dumps(res), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--rdv")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args)
    import torch

    card = "cpu"
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_dp_scaling: no CUDA device is available",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < args.world:
            print(f"torch_dp_scaling: {args.world} ranks need as many "
                  f"cards, {torch.cuda.device_count()} found",
                  file=sys.stderr)
            return 2
        from chip_smoke import card_line
        from deeplearning4j_tpu_torch.ops import _build

        _build.load()  # once, before the ranks start
        card = card_line()
    one = run_world(args, 1)
    many = run_world(args, args.world)
    print(json.dumps({
        "card": card, "world": args.world,
        "weak_scaling_efficiency": many["examples_per_s"]
        / (args.world * one["examples_per_s"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
