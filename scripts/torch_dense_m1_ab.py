#!/usr/bin/env python3
"""Every plan of the port's dense kernel at a few rows, on one CUDA card.

    python3 scripts/torch_dense_m1_ab.py [--rounds N]

At the conv listener's batch-1 forward (AlexNet's two dense layers,
9216 -> 4096 -> 4096, and LeNet-5's 800 -> 500), a sampler's one-row
FFN product (3072 -> 768), and AlexNet's first layer at 8 and 16 rows
(either side of ``SKINNY_MAX_M``), it launches every plan
``ops/tiling.py`` lists for ``matmul_block`` (the wide route, the tiled
route at each split count and, up to ``SKINNY_MAX_M`` rows, the skinny
route at each split count), each forced through the wrapper's launch,
holds each against the plain PyTorch version (rtol / atol 1e-4) and a
second launch (bitwise), then times them in interleaved rounds with
CUDA events around CUDA-graph replays, beside ``torch.addmm`` + relu
(the library call) and the bound (each operand read once, the output
written once, at the card's 3.35 TB/s). Prints the card's name and
power limit, then one JSON line a shape: each plan's median ms, the
heuristic's plan and the fastest. Exits non-zero without a card.
"""

import argparse
import importlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
SHAPES = [
    ("alexnet-b1.dense1", 1, 9216, 4096),
    ("alexnet-b1.dense2", 1, 4096, 4096),
    ("lenet-b1.dense1", 1, 800, 500),
    ("sample.ffn2@byte", 1, 3072, 768),
    ("alexnet.dense1@8", 8, 9216, 4096),
    ("alexnet.dense1@16", 16, 9216, 4096),
]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dense_m1_ab: no CUDA device is available",
              file=sys.stderr)
        return 2
    from chip_smoke import card_line, graph_ms
    from deeplearning4j_tpu_torch.ops import matmul_block_reference, tiling

    mb = importlib.import_module("deeplearning4j_tpu_torch.ops.matmul_block")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, m, k, n in SHAPES:
        x = torch.randn(m, k, device=dev, generator=gen)
        w = torch.randn(k, n, device=dev, generator=gen) / k ** 0.5
        b = 0.1 * torch.randn(n, device=dev, generator=gen)
        plans = tiling.matmul_candidates(m, k, n)
        with torch.inference_mode():
            ref = matmul_block_reference(x, w, b, activation="relu")
            for plan in plans:
                got = mb._launch(x, w, b, None, "relu", plan, count=False)
                again = mb._launch(x, w, b, None, "relu", plan, count=False)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4,
                                           msg=lambda s: f"{plan}: {s}")
                if not torch.equal(got, again):
                    raise RuntimeError(f"{name} {plan}: two launches differ")
            times = {tiling.plan_tag(p): [] for p in plans}
            times["addmm"] = []
            order = [(tiling.plan_tag(p), p) for p in plans]
            order.append(("addmm", None))
            for r in range(args.rounds):
                for tag, plan in (order if r % 2 == 0 else order[::-1]):
                    if plan is None:
                        def run():
                            return torch.addmm(b, x, w).relu_()
                    else:
                        def run(plan=plan):
                            return mb._launch(x, w, b, None, "relu", plan,
                                              count=False)
                    times[tag].append(graph_ms(torch, run))
        med = {tag: float(np.median(v)) for tag, v in times.items()}
        kernel_med = {t: v for t, v in med.items() if t != "addmm"}
        best = min(kernel_med, key=kernel_med.get)
        bound = 4.0 * (m * k + k * n + n + m * n) / HBM_BYTES_PER_S * 1e3
        print(json.dumps({
            "shape_of": name, "m": m, "k": k, "n": n,
            "route": mb.matmul_route(m, n),
            "heuristic": tiling.plan_tag(tiling.matmul_heuristic(m, k, n)),
            "fastest": best, "fastest_ms": kernel_med[best],
            "heuristic_ms": kernel_med[tiling.plan_tag(
                tiling.matmul_heuristic(m, k, n))],
            "library_ms": med["addmm"], "bound_ms": bound,
            "median_ms": med, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
