#!/usr/bin/env python3
"""A/B of the repeatable row fold of the port's Word2Vec on one card:
the segmented scan of ``embeddings/sparse.py`` in chunks of 32 rows
(two levels) against one flat Hillis-Steele scan over all the rows
(``_SCAN_CHUNK`` forced above the row count), in turns, at bench.py's
Word2Vec configuration (``chip_smoke.py``'s ``[word2vec]``: 200,000
words, V 2000, D 128, W 5, K 5, B 16,384, on-device epoch generation).

    python3 scripts/torch_w2v_fold_ab.py [--rounds 2]

Each turn builds a fresh trainer, fits one warm-up epoch, then times
the best of 2 windows of 20 epochs (host clock, synchronised) and the
device time of 2 epochs (``torch.profiler``). The two folds sum in
different trees: their tables after one epoch from the same seed are
held within 1e-5 of scale, and each is held bit for bit against a
second fit of its own. Prints one JSON line a turn, then the card's
name and power limit. Exits non-zero without a card.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def turn(torch, sparse, cs, cache, ids, chunk):
    sparse._SCAN_CHUNK = chunk
    words = sum(len(s) for s in ids)
    tables = []
    for _ in range(2):
        sv = cs.make_w2v(cache, ids)
        sv.fit()
        tables.append([t.clone() for t in (sv.lookup.syn0,
                                           sv.lookup.syn1neg)])
    if not all(torch.equal(a, b) for a, b in zip(*tables)):
        raise RuntimeError(f"chunk {chunk}: two fits differ")
    sv.epochs = cs.W2V_REPS
    sv.fit()
    windows = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sv.fit()
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
    sv.epochs = 2
    device_ms, top = cs.profiled_device_ms(torch, sv.fit)
    best = min(windows)
    return {"chunk": "flat" if chunk > 1 << 20 else chunk,
            "words_per_s": cs.W2V_REPS * words / best,
            "ms_per_epoch": best / cs.W2V_REPS * 1e3,
            "device_ms_per_epoch": device_ms / 2,
            "top_device_ms_per_epoch": {k[:50]: v / 2
                                        for k, v in top.items()}}, tables[0]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_w2v_fold_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.embeddings import sparse

    torch.backends.cuda.matmul.allow_tf32 = False
    cache, ids = cs.w2v_corpus()
    ref = None
    for _ in range(args.rounds):
        for chunk in (32, 1 << 62):
            rec, tables = turn(torch, sparse, cs, cache, ids, chunk)
            if ref is None:
                ref = tables
            rec["max_abs_diff_vs_first"] = max(
                cs.close_to_scale(torch, a, b, 1e-5)
                for a, b in zip(tables, ref))
            print(json.dumps(rec))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
