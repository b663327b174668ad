#!/usr/bin/env python3
"""Tensor parallelism, ring attention and GPipe over NCCL, one rank a
card: ``chip_smoke.py``'s ``[alexnet-tp]``, ``[ring-attention]`` and
``[gpipe]`` on a world of two ranks on two cards of one host, which
takes the NCCL routes its gloo world on one card never takes
(``all_gather_into_tensor`` for the tensor-parallel gathers,
``batch_isend_irecv`` for the ring's and the pipeline's hops).

    python3 scripts/torch_parallel_nccl.py

Each phase is held against the same reference as in ``chip_smoke.py``
(the world of one, the unsharded blocks, the serial composition); the
ring takes the transformer LM's blocks at their seeded initial weights
(``chip_smoke.py``'s are the trained ones). Prints each phase's line
and the card's name and power limit; exits non-zero with fewer than two
cards or on any failure.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _build

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_parallel_nccl: needs two CUDA devices", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"[env] card: {card}; devices {torch.cuda.device_count()}")
    _build.load()
    t0 = time.perf_counter()
    lm = MultiLayerNetwork(cs.tx_conf(), device="cuda").init()
    records = []
    paths = cs.run_rank_world(torch, card, records, lm, cs.survey_bytes(),
                              list(cs.WORLD_PHASES), backend="nccl")
    print(f"[nccl] launches by path: {paths}")
    print(f"[nccl] done {time.perf_counter() - t0:.1f} s")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
