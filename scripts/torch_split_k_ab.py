#!/usr/bin/env python3
"""A/B of the port's split-K path on one CUDA card, in one process.

    python3 scripts/torch_split_k_ab.py

For every shape of the serving slice whose split-K plan splits the
reduction (LeNet-5's second conv and dense layer at the serving bucket
of 32 rows, AlexNet's two dense layers at batch 64), it times the
kernel with the plan forced to one chunk (the unsplit path: one fused
launch) and with the plan as the library makes it, in turns (A B B A,
five rounds), with CUDA events around CUDA-graph replays. Both results
are held against the plain PyTorch version first. Prints one JSON line
per shape with every run, the medians and the card's name and power
limit; exits non-zero without a card.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ROUNDS = 5


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_split_k_ab: no CUDA device is available",
              file=sys.stderr)
        return 2
    from chip_smoke import card_line, graph_ms
    from deeplearning4j_tpu_torch.ops import (
        _build,
        conv_block,
        conv_block_reference,
        matmul_block,
        matmul_block_reference,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    lib = _build.load()
    planned = {"conv": lib.dl4j_conv_block_splits,
               "dense": lib.dl4j_matmul_block_splits}
    attr = {"conv": "dl4j_conv_block_splits",
            "dense": "dl4j_matmul_block_splits"}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [
        ("lenet.conv2", "conv", (32, 20, 12, 12), (50, 20, 5, 5)),
        ("lenet.dense1", "dense", (32, 800), (800, 512)),
        ("alexnet.dense1", "dense", (64, 9216), (9216, 4096)),
        ("alexnet.dense2", "dense", (64, 4096), (4096, 4096)),
    ]
    print(card)
    for name, kind, xs, ws in cases:
        x = torch.randn(xs, device=dev, generator=gen)
        fan_in = int(np.prod(ws[1:])) if kind == "conv" else ws[0]
        w = torch.randn(ws, device=dev, generator=gen) / fan_in ** 0.5
        b = 0.1 * torch.randn(ws[0] if kind == "conv" else ws[1],
                              device=dev, generator=gen)
        if kind == "conv":
            def run():
                return conv_block(x, w, b, activation="relu")

            def ref():
                return conv_block_reference(x, w, b, activation="relu")
        else:
            def run():
                return matmul_block(x, w, b, activation="relu")

            def ref():
                return matmul_block_reference(x, w, b, activation="relu")

        def unsplit(*_):
            return 1

        sides = {"unsplit": unsplit, "split": planned[kind]}
        times = {side: [] for side in sides}
        with torch.inference_mode():
            want = ref()
            for side, plan in sides.items():
                setattr(lib, attr[kind], plan)
                got = run()
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            for _ in range(ROUNDS):
                for side in ("unsplit", "split", "split", "unsplit"):
                    setattr(lib, attr[kind], sides[side])
                    times[side].append(graph_ms(torch, run))
        setattr(lib, attr[kind], planned[kind])
        splits = (planned[kind](xs[0], xs[1], ws[0], ws[2], ws[3],
                                xs[2] - ws[2] + 1, xs[3] - ws[3] + 1)
                  if kind == "conv" else planned[kind](xs[0], xs[1], ws[1]))
        print(json.dumps({
            "shape_of": name, "splits": splits,
            "unsplit_ms_median": float(np.median(times["unsplit"])),
            "split_ms_median": float(np.median(times["split"])),
            "unsplit_ms": times["unsplit"], "split_ms": times["split"],
            "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
