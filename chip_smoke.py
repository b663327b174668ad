#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on
one NVIDIA card, the quickest proof that the port still starts there.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits
non-zero (nothing is caught):

1. environment: the card's name and power limit (``nvidia-smi``), the
   PyTorch / CUDA versions, and the build of the hand-written kernels
   from ``deeplearning4j_tpu_torch/csrc`` (timed);
2. kernels: every kernel at every shape the slices give it, held
   against its plain PyTorch version on the card, with TF32 off on both
   sides, and timed (CUDA graphs of back-to-back launches, CUDA events)
   beside its plain version, one PyTorch library call that computes the
   same function (``library_ms``) and its bound on an H100 SXM. The
   forward kernels run at LeNet-5's largest serving bucket (32 rows) and
   its training batch (256), and at AlexNet's batch of 64; the backward
   kernels (``conv_bwd_data``, ``conv_bwd_w``) at LeNet-5's training
   shapes (batch 256) and AlexNet's (batch 64: conv2-conv5 dx, conv1-5
   dW, so the stride-4 and padded geometry run); the LSTM kernels at the
   char-RNN's chunk, its T 1 sampling launch and bench.py's saturated
   shape; the conv forward, both conv backward kernels and the dense
   kernel at every distinct shape of VGG-16's and ResNet-50's training
   steps (batch 128, the ``vgg16.`` and ``resnet50.`` records, with their
   launches a step); flash attention (both entries, f32 and bf16) at the transformer's training shape and the
   streamed entry at t 16384; the dense kernel at the transformer's input
   projection and its residual variant at the FFN's second product, and
   at the embedding MLP's dense layer (``embedding-mlp.dense``: m 1024,
   k 128, n 256, relu). Each record names the kernel route its shape
   took; the run fails when a main-path shape of the conv forward,
   ``conv_bwd_data``, ``conv_bwd_w``, the dense kernel, the LSTM cell or
   the LSTM sequence kernels took another route than the one designed for it
   (``INTENDED_ROUTES``). The LSTM layers are also timed against
   ``torch.nn.LSTM`` (cuDNN) on the device clock;
3. serving (a main path): ``ModelServer`` with a full-width LeNet-5
   (random weights from a seed) on the card answers solo and concurrent
   ``/predict`` requests; every answer is checked against the plain
   path (the same weights on the CPU), the kernels' launch counters are
   zeroed just before and read just after, and latency and throughput
   are printed;
4. training (a main path): full-width LeNet-5 (Adam, MCXENT, batch 256)
   fits synthetic MNIST through ``MultiLayerNetwork.fit``; one step's
   launches are counted exactly, three steps are held against the CPU
   twin (the plain path) and repeated bitwise, the score must fall over
   about 50 steps, and examples/s and ms/step are printed;
5. AlexNet at 224x224x3 / 1000 classes through
   ``MultiLayerNetwork.output``, checked against the plain path and
   timed; ``[alexnet-train]`` the zoo's AlexNet trained through ``fit``
   (NESTEROVS lr 0.01, batch 128, dropout 0.5 on both dense layers, the
   masks of ``nn/random.py``): one batch-4 step held against the CPU
   twin (the same masks) with every kernel call held on its operands and
   repeated bitwise, one step's launches exact (10 ``conv_block``, 4
   ``conv_bwd_data``, 5 ``conv_bwd_w``, 2 ``matmul_block``), 6 steps
   over which the score falls (host and device ms a step, busy share,
   images/s, peak memory, the masks' device ms); every distinct kernel
   shape of its step is among the ``[kernel]`` records
   (``alexnet-train.``);
6. the GravesLSTM char-RNN (main paths), with and without peepholes:
   truncated-BPTT ``fit`` on SURVEY.md's characters, ``output`` and
   ``rnn_time_step`` sampling, held against the CPU twin;
7. the transformer LM (main paths) at bench.py:866's widths (d 768, 12
   layers, 12 heads, vocab 256): ``[transformer]`` 20 Adam steps of
   ``fit`` at batch 16 x t 512 on SURVEY.md's bytes (tokens/s, ms/step,
   device ms/step and busy share, launches exact);
   ``[transformer-twin]`` the same model at batch 4, 2 steps against the
   CPU twin;
   ``[transformer-sample]`` KV-cache sampling through ``rnn_time_step``
   held against ``output``; ``[transformer-long]`` ``output`` at t 16384
   (the streamed entry) against ``output`` on its first 512 bytes;
8. VGG-16 (main paths): ``[vgg16]`` the zoo's VGG-16 at full depth and
   width (f32) as a ``ComputationGraph`` on synthetic CIFAR-10
   (``CifarDataSetIterator``): ``output`` at batch 128 against the CPU
   twin, one step's launches exact (26 ``conv_block``, 12
   ``conv_bwd_data``, 13 ``conv_bwd_w``, 2 ``matmul_block``), three
   steps at batch 32 against the twin and repeated bitwise, 20 NESTEROVS
   steps of ``fit`` over which the score falls (examples/s, ms/step,
   device ms/step and busy share); ``[conv-bn]`` a MultiLayer
   Conv(identity) -> BatchNormalization(relu) block at VGG-16's first
   widths: the inference forward folded into one ``conv_block`` launch
   against the unfused plain path, and a training step's running
   statistics against the CPU twin's;
9. ResNet-50 (main paths): ``[resnet50]`` the zoo's ResNet-50 at 224 x
   224, 1000 classes, full depth and width (f32) as a
   ``ComputationGraph`` on synthetic uint8 pixels: ``output`` at batch
   128 against the CPU twin, two batch-4 steps each held to the twin
   from the same state with every conv kernel call held to its plain
   version on the same operands, one step's launches exact (106
   ``conv_block``, 52 ``conv_bwd_data``, 53 ``conv_bwd_w``), 6 NESTEROVS
   steps at batch 128 over which the score falls (examples/s, ms/step,
   device ms/step and busy share, peak memory); every distinct kernel
   shape of its step is among the ``[kernel]`` records (``resnet50.``);
   ``[resnet50-dp]`` ``DistributedTrainer(batch_stats="sync")`` over an
   NCCL world of one formed through a file rendezvous: three steps
   bitwise equal to the plain graph's, one ZeRO-1 step bitwise equal to
   the replicated one, and the two step times;
10. the NLP / embeddings slice (main paths): ``[word2vec]`` bench.py's
   Word2Vec configuration exactly (a Zipf corpus of 200,000 words over
   2,000, D 128, W 5, K 5, B 16,384) through ``Word2Vec.fit`` with
   on-device epoch generation: words/s (best of 3 windows of 20
   epochs), the cold rate, device ms an epoch and busy share, peak
   memory, two fits from the seed equal bit for bit and one epoch held
   to the CPU twin on the card's draws; ``[word2vec-host]`` one epoch of
   the chunked host-pair route against its CPU twin; ``[deepwalk]``
   (a graph of BlogCatalog's counts), ``[glove]`` and
   ``[paragraph-vectors]``, each with its rate and a CPU twin (every
   twin holds what the run changed in each table, ``hold_change``);
   ``[embedding-mlp]`` EmbeddingLayer -> Dense (``matmul_block``, held
   to its plain version at the dense shape, ``embedding-mlp.dense``) ->
   softmax, 5 Adam steps, launches exact; on an NCCL world of one,
   ``[word2vec-sharded]`` (``ShardedWord2Vec`` against the host route,
   save/restore bitwise) and ``[zero]`` (a ``zero=True`` checkpoint
   equal to the replicated one's, parameter-shaped);
11. half-precision training (main paths), after the kernels' bf16
   variants are held against their plain versions at every distinct
   conv shape of a ResNet-50 step (the forward half in / half out and
   half in / f32 out, dW on a bf16 image; beside cuDNN's bf16 calls):
   ``[resnet50-bf16]`` bench.py's pure-bf16 ResNet-50 (NESTEROVS lr
   0.01, batch 128; two batch-4 steps held to the CPU twin with every
   conv kernel call held on its operands, then 6 steps, launches exact
   by dtype variant, peak memory); ``[vgg16-bf16]`` bench.py's pure-bf16
   VGG-16 (4 minibatches x 2 epochs); ``[transformer-bf16]`` the LM
   with bf16 compute over f32 masters (20 Adam steps: masters and
   moments f32, activations and kernels bf16); ``[f16-loss-scale]`` the
   LM in f16 compute from a loss scale of 2**24 (12 steps: each overflow
   step skipped bitwise with the scale halved, then clean steps);
   ``[guard]`` [train]'s LeNet-5 under ``DivergenceGuard("skip")`` with
   a ``StatGuardConfig``, a NaN minibatch and a mislabelled one both
   skipped bitwise, the guarded step's device time beside the
   unguarded one's; ``[megastep]`` ``fit(megastep=K)``, each chunk one
   CUDA-graph replay with one readback: [train]'s LeNet-5 over 48
   minibatches per step and at K = 6 (trees bitwise equal, 8 readbacks,
   host ms a step and busy share both ways), the narrow AlexNet with
   dropout at K = 4 bitwise equal to its per-step run, and [guard]'s
   poisoned run at K = 6 (the same skipped steps and trees).

The last lines are the card line, one JSON object with the per-kernel
numbers, and ``{"ok": true, "device": {...}}``. Exits non-zero without
a CUDA device, and when the port's package is not beside it.
"""

import http.client
import importlib
import json
import subprocess
import sys
import threading
import time

import numpy as np

# H100 SXM data-sheet peaks (dense, no sparsity) at the 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

LENET_BUCKET = 32
LENET_TRAIN_BATCH = 256
LENET_TRAIN_STEPS = 50
ALEXNET_BATCH = 64
ALEXNET_TRAIN_BATCH = 128
ALEXNET_TWIN_BATCH = 4
ALEXNET_TRAIN_STEPS = 6

# the GravesLSTM char-RNN (BASELINE.json config #3, bench.py:533)
CHAR_VOCAB = 77
CHAR_HIDDEN = 200
CHAR_BATCH = 32
CHAR_SEGMENT = 200
CHAR_TBPTT = 50
CHAR_MINIBATCHES = 24
CHAR_SAMPLE = 200
# bench.py:596's saturated LSTM shape
SATURATED = (128, 256, 1024)

# the transformer LM (bench.py:866 bench_transformer's configuration)
TX = dict(vocab=256, d_model=768, n_layers=12, n_heads=12,
          learning_rate=3e-4)
TX_BATCH = 16
TX_T = 512
TX_STEPS = 20
TX_PROMPT = 256
TX_SAMPLE = 64
TX_LONG_T = 16384
# H100 SXM dense tensor-core peaks: bf16 / f16 operands, and TF32 (the
# rate of a product with an f32 operand on the tensor cores)
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12

# VGG-16 on CIFAR-10 (BASELINE.json config #2; bench.py:480's batch)
VGG_BATCH = 128
VGG_TWIN_BATCH = 32
VGG_BATCHES = 4
VGG_EPOCHS = 5
# the conv -> BN fold at VGG-16's first widths
RESNET_BATCH = 128  # bench.py:823, cut to f32
RESNET_TWIN_BATCH = 4
RESNET_STEPS = 6

CONV_BN_BATCH = 128
CONV_BN_CHANNELS = 64
CONV_BN_HW = 32

# Word2Vec skip-gram (BASELINE.json config #4; bench.py:699 bench_word2vec)
W2V_SENTENCES = 5000
W2V_SENT_LEN = 40
W2V_VOCAB = 2000
W2V_DIM = 128
W2V_WINDOW = 5
W2V_NEG = 5
W2V_BATCH = 16384
W2V_SEED = 1
W2V_REPS = 20  # epochs a timed window
W2V_TWIN_SENTENCES = 1000  # the host route's CPU twin, cut
# DeepWalk on a graph of BlogCatalog's counts (the DeepWalk paper's)
DW_VERTICES = 10312
DW_EDGES = 333983
DW_DIM = 128
DW_WINDOW = 10
DW_WALK = 40
DW_SEED = 7
DW_TWIN_WALKS = 256
GLOVE_EPOCHS = 5
PV_DOCS = 1000
PV_EPOCHS = 5
# the embedding MLP: EmbeddingLayer(2000 -> 128) -> Dense 256 -> softmax
MLP_VOCAB = 2000
MLP_BATCH = 1024
MLP_HIDDEN = 256
MLP_STEPS = 5
# a CPU twin holds each table's change within this share of the twin's
# largest change (f32 both sides, sums in another order)
TWIN_REL = 1e-3
TWIN_TOLERANCE = f"each table's change within {TWIN_REL:g} of the twin's"


def survey_corpus(vocab=CHAR_VOCAB):
    """The char-RNN's training text: the characters of ``SURVEY.md``
    (beside this script) as ids. The ``vocab - 1`` most frequent
    characters (ties by code point) map to ids 0 .. vocab - 2 in that
    order, every other character to ``vocab - 1``. Returns ``(ids,
    alphabet)``."""
    from collections import Counter
    from pathlib import Path

    text = (Path(__file__).resolve().parent / "SURVEY.md").read_text(
        encoding="utf-8")
    counts = Counter(text)
    alphabet = sorted(counts, key=lambda ch: (-counts[ch], ch))[:vocab - 1]
    index = {ch: i for i, ch in enumerate(alphabet)}
    ids = np.array([index.get(ch, vocab - 1) for ch in text], np.int64)
    return ids, alphabet


def char_batches(ids, batch, length, n_batches, seed, vocab=CHAR_VOCAB):
    """``n_batches`` minibatches of ``batch`` segments of ``length``
    characters at seeded random offsets, one-hot ``[batch, vocab,
    length]``; the labels are each position's next character."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    rng = np.random.RandomState(seed)
    eye = np.eye(vocab, dtype=np.float32)
    out = []
    for _ in range(n_batches):
        starts = rng.randint(0, len(ids) - length - 1, batch)
        seg = np.stack([ids[s:s + length + 1] for s in starts])
        out.append(DataSet(
            np.ascontiguousarray(eye[seg[:, :-1]].transpose(0, 2, 1)),
            np.ascontiguousarray(eye[seg[:, 1:]].transpose(0, 2, 1))))
    return out


def survey_bytes():
    """The transformer's token stream: the bytes of ``SURVEY.md``
    (beside this script) as ids 0..255."""
    from pathlib import Path

    raw = (Path(__file__).resolve().parent / "SURVEY.md").read_bytes()
    return np.frombuffer(raw, np.uint8).astype(np.int64)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_shapes(conf, batch):
    """(name, kind, geometry) of every kernel launch one forward of
    ``conf`` at ``batch`` rows makes, from its InputType inference."""
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer,
        DenseLayer,
    )
    from deeplearning4j_tpu_torch.ops import SUPPORTED_EPILOGUES

    out = []
    it = conf.input_type
    n_conv = n_dense = 0
    for i, layer in enumerate(conf.layers):
        if i in conf.preprocessors:
            it = conf.preprocessors[i].output_type(it)
        act = layer.activation.lower()
        if isinstance(layer, ConvolutionLayer) and act in SUPPORTED_EPILOGUES:
            n_conv += 1
            out.append((f"conv{n_conv}", "conv_block", dict(
                x=(batch, it.channels, it.height, it.width),
                w=(layer.n_out, layer.n_in) + tuple(layer.kernel_size),
                stride=tuple(layer.stride), padding=tuple(layer.padding),
                activation=act, input_is_data=i == 0)))
        elif isinstance(layer, DenseLayer) and act in SUPPORTED_EPILOGUES:
            n_dense += 1
            out.append((f"dense{n_dense}", "matmul_block", dict(
                m=batch, k=layer.n_in, n=layer.n_out, activation=act)))
        it = layer.output_type(it)
    return out


def graph_kernel_shapes(conf, batch):
    """(vertex, kind, geometry) of every kernel launch one forward of the
    ComputationGraph ``conf`` at ``batch`` rows makes, in topological
    order, from its InputType inference."""
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer,
        DenseLayer,
    )
    from deeplearning4j_tpu_torch.ops import SUPPORTED_EPILOGUES

    types = dict(zip(conf.inputs, conf.input_types))
    out = []
    for name in conf.topological_order():
        v = conf.vertices[name]
        in_types = [types[s] for s in conf.vertex_inputs[name]]
        types[name] = v.output_type(in_types)
        layer = v.layer()
        if layer is None:
            continue
        it = in_types[0]
        if v.preprocessor is not None:
            it = v.preprocessor.output_type(it)
        act = layer.activation.lower()
        if isinstance(layer, ConvolutionLayer) and act in SUPPORTED_EPILOGUES:
            out.append((name, "conv_block", dict(
                x=(batch, it.channels, it.height, it.width),
                w=(layer.n_out, layer.n_in) + tuple(layer.kernel_size),
                stride=tuple(layer.stride), padding=tuple(layer.padding),
                activation=act,
                input_is_data=conf.vertex_inputs[name][0] in conf.inputs)))
        elif isinstance(layer, DenseLayer) and act in SUPPORTED_EPILOGUES:
            out.append((name, "matmul_block", dict(
                m=batch, k=layer.n_in, n=layer.n_out, activation=act)))
    return out


def step_shapes(shapes):
    """The launches of one training step from a forward's
    (name, kind, geometry) list: each forward launch, dW of every fused
    conv and dx of every one whose input is not the data (the data
    needs no gradient). The conv forward's f32 recompute in the backward
    is a second conv_block launch at the same shape."""
    out = []
    for name, kind, geo in shapes:
        out.append((name, kind, geo))
        if kind != "conv_block":
            continue
        if not geo.get("input_is_data"):
            out.append((name, "conv_bwd_data", geo))
        out.append((name, "conv_bwd_w", geo))
    return out


def distinct_shapes(shapes):
    """(first name, kind, geometry, names) for each distinct (kind,
    geometry) of ``shapes``, in order: a kernel is timed once a shape."""
    seen = {}
    for name, kind, geo in shapes:
        key = (kind, json.dumps({k: v for k, v in geo.items()
                                 if k != "input_is_data"}, sort_keys=True))
        if key in seen:
            seen[key][3].append(name)
        else:
            seen[key] = [name, kind, geo, [name]]
    return [tuple(v) for v in seen.values()]


def vgg_shapes(batch=VGG_BATCH):
    """The distinct kernel shapes of one VGG-16 training step at
    ``batch``: (first vertex, kind, geometry, vertices)."""
    from deeplearning4j_tpu_torch.zoo import vgg16

    return distinct_shapes(step_shapes(graph_kernel_shapes(vgg16(), batch)))


def resnet_shapes(batch=RESNET_BATCH):
    """The distinct kernel shapes of one ResNet-50 training step at
    ``batch`` (224 x 224): (first vertex, kind, geometry, vertices)."""
    from deeplearning4j_tpu_torch.zoo import resnet50

    return distinct_shapes(step_shapes(graph_kernel_shapes(resnet50(),
                                                           batch)))


def graph_ms(torch, fn, reps: int = 10) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a
    CUDA graph, replayed until ~50 ms have run, timed with events (so
    host launch overhead does not count)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    g.replay()
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    n = max(1, min(200, int(50.0 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * reps)


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def conv_out(size, k, st, p):
    return (size + 2 * p - k) // st + 1


def useful_macs(geo):
    """Multiply-adds of a conv that touch the input (taps that fall on
    the padding do no work), over the whole batch."""
    n, c, h, w_ = geo["x"]
    o, _, kh, kw = geo["w"]
    (sh, sw), (ph, pw) = geo["stride"], geo["padding"]

    def taps(size, k, st, p):
        return sum(1 for oy in range(conv_out(size, k, st, p))
                   for d in range(k) if 0 <= oy * st - p + d < size)

    return n * o * c * taps(h, kh, sh, ph) * taps(w_, kw, sw, pw)


def check_bwd_kernel(torch, model, name, kind, geo, gen):
    """A backward kernel vs its plain version on the card at ``geo``;
    returns one record with the error, the times and the bound."""
    from deeplearning4j_tpu_torch.ops import (
        conv_bwd_data,
        conv_bwd_data_reference,
        conv_bwd_w,
        conv_bwd_w_reference,
    )
    from deeplearning4j_tpu_torch.ops.conv_block import (
        conv_bwd_data_route,
        conv_bwd_w_route,
    )

    dev = torch.device("cuda")
    xs, ws = tuple(geo["x"]), tuple(geo["w"])
    st, pad = tuple(geo["stride"]), tuple(geo["padding"])
    oh, ow = (conv_out(xs[2], ws[2], st[0], pad[0]),
              conv_out(xs[3], ws[3], st[1], pad[1]))
    x = torch.randn(xs, device=dev, generator=gen)
    w = torch.randn(ws, device=dev, generator=gen) / (ws[1] * ws[2]
                                                      * ws[3]) ** 0.5
    dacc = torch.randn((xs[0], ws[0], oh, ow), device=dev, generator=gen)
    if kind == "conv_bwd_data":
        def kernel():
            return conv_bwd_data(dacc, w, xs[2:], st, pad)

        def plain():
            return conv_bwd_data_reference(dacc, w, xs[2:], st, pad)

        def library():
            return torch.nn.grad.conv2d_input(xs, w, dacc, stride=st,
                                              padding=pad)
        nbytes = 4.0 * (dacc.numel() + w.numel() + x.numel())
    else:
        def kernel():
            return conv_bwd_w(x, dacc, ws, st, pad)

        def plain():
            return conv_bwd_w_reference(x, dacc, ws, st, pad)

        def library():
            return torch.nn.grad.conv2d_weight(x, ws, dacc, stride=st,
                                               padding=pad)
        nbytes = 4.0 * (x.numel() + dacc.numel() + w.numel())
    flops = 2.0 * useful_macs(geo)
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    # f32 on both sides (TF32 off), sums in another order over up to
    # 193,600 products of O(1) terms: held relative to the largest entry
    torch.testing.assert_close(got, ref, rtol=0, atol=5e-5 * max(scale, 1.0))
    again = kernel()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise RuntimeError(f"{model}.{name} {kind}: two launches differ")
    ms = graph_ms(torch, kernel)
    plain_ms = graph_ms(torch, plain)
    library_ms = graph_ms(torch, library)
    bound_ms, bound_by = bound(flops, nbytes)
    pick = conv_bwd_data_route if kind == "conv_bwd_data" else \
        conv_bwd_w_route
    route = pick(*xs, ws[0], ws[2], ws[3], st, pad).route
    return {"kernel": kind, "kernel_route": route,
            "shape_of": f"{model}.{name}", "x": list(xs),
            "w": list(ws), "stride": list(st), "padding": list(pad),
            "max_abs_err": err, "rel_err": err / max(scale, 1e-30),
            "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "gflop": flops / 1e9, "mb": nbytes / 1e6}


def check_kernel(torch, F, model, name, kind, geo, gen):
    """Kernel vs plain version on the card at ``geo``; returns one
    record with the error, the times and the bound."""
    from deeplearning4j_tpu_torch.ops import (
        conv_block,
        conv_block_reference,
        matmul_block,
        matmul_block_reference,
    )
    from deeplearning4j_tpu_torch.ops.conv_block import conv_block_route
    from deeplearning4j_tpu_torch.ops.matmul_block import matmul_route

    dev = torch.device("cuda")
    act = geo["activation"]
    if kind == "conv_block":
        x = torch.randn(geo["x"], device=dev, generator=gen)
        fan_in = geo["w"][1] * geo["w"][2] * geo["w"][3]
        w = torch.randn(geo["w"], device=dev, generator=gen) / fan_in ** 0.5
        b = 0.1 * torch.randn(geo["w"][0], device=dev, generator=gen)
        kw = dict(stride=geo["stride"], padding=geo["padding"],
                  activation=act)

        def kernel():
            return conv_block(x, w, b, **kw)

        def plain():
            return conv_block_reference(x, w, b, **kw)

        def library():
            y = F.conv2d(x, w, b, stride=geo["stride"],
                         padding=geo["padding"])
            return torch.relu_(y) if act == "relu" else y
        out_shape = kernel().shape
        flops = 2.0 * out_shape.numel() * w[0].numel()
        nbytes = 4.0 * (x.numel() + w.numel() + b.numel()
                        + out_shape.numel())
        shape = {"x": list(geo["x"]), "w": list(geo["w"]),
                 "stride": list(geo["stride"]),
                 "padding": list(geo["padding"])}
    else:
        m, k, n = geo["m"], geo["k"], geo["n"]
        x = torch.randn(m, k, device=dev, generator=gen)
        w = torch.randn(k, n, device=dev, generator=gen) / k ** 0.5
        b = 0.1 * torch.randn(n, device=dev, generator=gen)

        def kernel():
            return matmul_block(x, w, b, activation=act)

        def plain():
            return matmul_block_reference(x, w, b, activation=act)

        def library():
            return torch.relu_(torch.addmm(b, x, w))
        flops = 2.0 * m * k * n
        nbytes = 4.0 * (x.numel() + w.numel() + b.numel() + m * n)
        shape = {"m": m, "k": k, "n": n}
    if act not in ("relu", "identity") or (kind != "conv_block"
                                           and act != "relu"):
        raise ValueError(f"{name}: no library yardstick for {act}")
    with torch.inference_mode():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        # f32 on both sides (TF32 off), sums in another order over up to
        # 9216 terms of O(1) outputs
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        if model == "lenet":  # the bf16 path, once per kernel and shape
            xb, wb = x.bfloat16(), w.bfloat16()
            if kind == "conv_block":
                gb = conv_block(xb, wb, b, **kw)
                rb = conv_block_reference(xb, wb, b, **kw)
            else:
                gb = matmul_block(xb, wb, b, activation=act)
                rb = matmul_block_reference(xb, wb, b, activation=act)
            torch.testing.assert_close(gb.float(), rb.float(), rtol=2e-2,
                                       atol=2e-2)
        ms = graph_ms(torch, kernel)
        plain_ms = graph_ms(torch, plain)
        library_ms = graph_ms(torch, library)
    bound_ms, bound_by = bound(flops, nbytes)
    tile = None
    if kind == "conv_block":
        plan = conv_block_route(*geo["x"], geo["w"][0], *geo["w"][2:],
                                geo["stride"], geo["padding"])
        route = plan.route
        if route == "wide":
            tile = f"{plan.tile_o}x{plan.tile_px}"
    else:
        route = matmul_route(geo["m"], geo["n"])
    return {"kernel": kind, "kernel_route": route, "kernel_tile": tile,
            "shape_of": f"{model}.{name}", **shape,
            "max_abs_err": err, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "gflop": flops / 1e9, "mb": nbytes / 1e6}


def post(port: int, feats):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/predict", body=json.dumps(
            {"features": feats.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        dt = time.perf_counter() - t0
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"/predict answered {resp.status}: {body}")
    return np.asarray(body["output"], np.float32), dt


def cpu_twin(torch, model):
    """The same network (a ``MultiLayerNetwork`` or a
    ``ComputationGraph``), weights and layer state on the CPU: the plain
    path."""
    twin = type(model)(model.conf, device="cpu").init(params={
        ln: {pn: t.cpu() for pn, t in lp.items()}
        for ln, lp in model.params.items()})
    twin.state = {ln: {k: t.cpu() for k, t in st.items()}
                  for ln, st in model.state.items()}
    return twin


def serve_lenet(torch, card):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.serving import ModelServer
    from deeplearning4j_tpu_torch.zoo import lenet

    net = MultiLayerNetwork(lenet(), device="cuda").init()
    server = ModelServer(net, device="cuda", workers=16, queue_depth=64,
                         max_batch_size=LENET_BUCKET)
    t0 = time.perf_counter()
    server.start()
    print(f"[serve] LeNet-5 full width ({net.num_params()} params) on "
          f"{card}; {len(server.batcher.ladder.buckets)} buckets warmed in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(0)
    sent, answers = [], []
    try:
        dispatch.reset_launch_counts()
        solo_lat = []
        for _ in range(16):
            x = rng.rand(1, 784).astype(np.float32)
            out, dt = post(server.port, x)
            sent.append(x)
            answers.append(out)
            solo_lat.append(dt)
        lock = threading.Lock()
        loaded_lat = []
        clients, per_client = 16, 12
        batches = [[rng.rand(int(rng.randint(1, 5)), 784).astype(np.float32)
                    for _ in range(per_client)] for _ in range(clients)]

        def client(xs):
            for x in xs:
                out, dt = post(server.port, x)
                with lock:
                    sent.append(x)
                    answers.append(out)
                    loaded_lat.append(dt)

        threads = [threading.Thread(target=client, args=(b,))
                   for b in batches]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            if t.is_alive():
                raise RuntimeError("a serving client did not finish")
        wall = time.perf_counter() - t0
        launches = dispatch.launch_counts()
        snap = server.metrics_snapshot()
    finally:
        server.stop()
    # the forward alone, as the drain thread runs it (numpy rows in,
    # host array out), and its device time (the same forward on a card
    # tensor, replayed from a CUDA graph), to split request latency
    # into HTTP + JSON, host-side forward and device work
    forward_ms, device_ms = {}, {}
    for rows in (1, LENET_BUCKET):
        x = rng.rand(rows, 784).astype(np.float32)
        times = []
        for _ in range(21):
            t0 = time.perf_counter()
            net.output(x).cpu()
            times.append(time.perf_counter() - t0)
        forward_ms[rows] = float(np.median(times[1:])) * 1e3
        xt = torch.from_numpy(x).cuda()
        device_ms[rows] = graph_ms(torch, lambda: net.output(xt))
    print(f"[serve] launches during the requests: {launches}")
    for k in ("conv_block", "matmul_block"):
        if launches[k] <= 0:
            raise RuntimeError(f"the serving path launched no {k} kernel")
    occupancy = {int(k): v for k, v in snap["batch_items"].items()}
    print(f"[serve] requests per dispatched batch: {occupancy}")
    if max(occupancy) < 2:
        raise RuntimeError("no micro-batch held more than one request")
    # every answer against the plain path on the same weights (CPU)
    ref = cpu_twin(torch, net).output(np.concatenate(sent)).numpy()
    got = np.concatenate(answers)
    err = float(np.abs(got - ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    if not np.all(np.isfinite(got)) or got.shape != (len(ref), 10):
        raise RuntimeError(f"bad serving output {got.shape}")
    n_req = clients * per_client
    rows = sum(x.shape[0] for b in batches for x in b)
    res = {
        "solo_p50_ms": float(np.median(solo_lat)) * 1e3,
        "loaded_p50_ms": float(np.median(loaded_lat)) * 1e3,
        "loaded_p99_ms": float(np.quantile(loaded_lat, 0.99)) * 1e3,
        "requests_per_s": n_req / wall, "rows_per_s": rows / wall,
        "clients": clients, "requests": len(answers),
        "forward_ms_1_row": forward_ms[1],
        f"forward_ms_{LENET_BUCKET}_rows": forward_ms[LENET_BUCKET],
        "device_ms_1_row": device_ms[1],
        f"device_ms_{LENET_BUCKET}_rows": device_ms[LENET_BUCKET],
        "max_abs_err_vs_plain": err,
    }
    print(f"[serve] {json.dumps(res)} card={card}")
    return launches


def train_lenet(torch, card):
    """Full-width LeNet-5 fits synthetic MNIST on the card through
    ``MultiLayerNetwork.fit``; returns the launch counts of that run."""
    import warnings

    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.zoo import lenet

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        data = MnistDataSetIterator(
            LENET_TRAIN_BATCH, allow_synthetic=True,
            num_examples=LENET_TRAIN_BATCH * LENET_TRAIN_STEPS)
    batches = list(data)
    conf = lenet()
    lr = conf.layers[0].learning_rate
    net = MultiLayerNetwork(conf, device="cuda").init()
    init = {ln: {pn: t.clone() for pn, t in lp.items()}
            for ln, lp in net.params.items()}
    twin = cpu_twin(torch, net)
    print(f"[train] LeNet-5 full width ({net.num_params()} params), Adam "
          f"lr {lr}, MCXENT, batch {LENET_TRAIN_BATCH}, synthetic MNIST "
          f"({data.total_examples()} examples)")

    # three steps on the card and on the CPU twin (the plain path). Adam
    # moves a weight by about lr a step whatever its gradient's size, so
    # a gradient at the f32 noise floor can move differently in the two:
    # scores within rtol 1e-3, every weight within 3 lr, and at most 1 %
    # of any parameter's entries beyond 1e-4 + 1e-3 |w|
    card_scores, cpu_scores = [], []
    for ds in batches[:3]:
        net.fit(ds)
        twin.fit(ds)
        card_scores.append(net.score_value)
        cpu_scores.append(twin.score_value)
    np.testing.assert_allclose(card_scores, cpu_scores, rtol=1e-3)
    max_diff, max_off = 0.0, 0.0
    for ln, lp in twin.params.items():
        for pn, ref in lp.items():
            d = (net.params[ln][pn].cpu() - ref).abs()
            off = float((d > 1e-4 + 1e-3 * ref.abs()).float().mean())
            max_diff, max_off = max(max_diff, float(d.max())), max(max_off,
                                                                   off)
            if float(d.max()) > 3 * lr or off > 0.01:
                raise RuntimeError(f"card and CPU twin differ at {ln}/{pn}: "
                                   f"max {float(d.max())}, {off:.2%} off")
    # the same three steps again from the same start: the same bits
    again = MultiLayerNetwork(conf, device="cuda").init(params=init)
    for ds in batches[:3]:
        again.fit(ds)
    torch.cuda.synchronize()
    for ln, lp in net.params.items():
        for pn, t in lp.items():
            same = torch.equal(t, again.params[ln][pn]) and all(
                torch.equal(a, b) for a, b in zip(
                    net.updater_state[ln][pn], again.updater_state[ln][pn]))
            if not same:
                raise RuntimeError(f"two card runs differ at {ln}/{pn}")
    # one step's launches, exactly: the forward's two convs and dense,
    # each conv's f32 recompute, dW of both convs, dx of the second
    dispatch.reset_launch_counts()
    net.fit(batches[3])
    torch.cuda.synchronize()
    per_step = dispatch.launch_counts()
    expected = {k: 0 for k in dispatch.KERNELS}
    expected.update(conv_block=4, conv_bwd_data=1, conv_bwd_w=2,
                    matmul_block=1)
    if per_step != expected:
        raise RuntimeError(f"one LeNet step launched {per_step}, expected "
                           f"{expected}")

    # the main path: a fresh network fits the iterator, timed
    model = MultiLayerNetwork(conf, device="cuda").init(params=init)
    probe = batches[0]
    before = model.score(probe)
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    steps = model.iteration_count
    if launches != {k: v * steps for k, v in per_step.items()}:
        raise RuntimeError(f"{steps} steps launched {launches}")
    after = model.score(probe)
    if not np.isfinite(after) or not after < 0.5 * before:
        raise RuntimeError(f"the score did not fall: {before} -> {after}")
    # one step's device time: the step replayed from a CUDA graph
    step = model._train_step()
    x = torch.from_numpy(probe.features).cuda()
    y = torch.from_numpy(probe.labels).cuda()
    lrs = model.updater_def.scheduled_lrs(model.iteration_count)
    t = model.iteration_count + 1
    device_ms = graph_ms(torch, lambda: step(
        model.params, model.updater_state, model.state, x, y, None, lrs, t),
        reps=3)
    ms_per_step = wall / steps * 1e3
    res = {"steps": steps, "batch": LENET_TRAIN_BATCH,
           "examples_per_s": steps * LENET_TRAIN_BATCH / wall,
           "ms_per_step": ms_per_step, "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / ms_per_step,
           "score_before": before, "score_after": after,
           "launches_per_step": per_step,
           "twin_scores": {"card": card_scores, "cpu": cpu_scores},
           "twin_max_abs_diff": max_diff, "twin_max_share_off": max_off}
    print(f"[train] {json.dumps(res)} card={card}")
    return launches


def run_alexnet(torch, card):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.zoo import alexnet

    net = MultiLayerNetwork(alexnet(), device="cuda").init()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand(ALEXNET_BATCH, 3, 224, 224, device="cuda", generator=gen)
    dispatch.reset_launch_counts()
    out = net.output(x)
    torch.cuda.synchronize()
    per_forward = dispatch.launch_counts()
    expected = {k: 0 for k in dispatch.KERNELS}
    expected.update(conv_block=5, matmul_block=2)
    if per_forward != expected:
        raise RuntimeError(f"AlexNet forward launched {per_forward}")
    if out.shape != (ALEXNET_BATCH, 1000) or not torch.isfinite(out).all():
        raise RuntimeError(f"bad AlexNet output {tuple(out.shape)}")
    # the plain path on the same weights, on the first rows (CPU);
    # deep f32 sums in another order: rtol 1e-3 on the probabilities
    n_ref = 4
    ref = cpu_twin(torch, net).output(x[:n_ref].cpu())
    err = float((out[:n_ref].cpu() - ref).abs().max())
    torch.testing.assert_close(out[:n_ref].cpu(), ref, rtol=1e-3,
                               atol=1e-6)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.output(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times[1:])) * 1e3
    res = {"batch": ALEXNET_BATCH, "ms_per_batch": ms,
           "images_per_s": ALEXNET_BATCH / ms * 1e3,
           "launches_per_forward": per_forward,
           "max_abs_err_vs_plain": err, "params": net.num_params()}
    print(f"[alexnet] {json.dumps(res)} card={card}")


def alexnet_train_shapes(batch=ALEXNET_TRAIN_BATCH):
    """The distinct kernel shapes of one training step of the zoo's
    AlexNet at ``batch`` (224 x 224): (first layer, kind, geometry,
    layers)."""
    from deeplearning4j_tpu_torch.zoo import alexnet

    return distinct_shapes(step_shapes(kernel_shapes(alexnet(), batch)))


def dropout_ms(torch, conf, batch, seed=42):
    """Device ms of one training step's dropout on the card: each layer
    with a rate draws its input mask at ``batch`` rows and applies it
    (``maybe_dropout``: the counter hash, the compare and the inverted
    scaling), from its key as a step derives it on the host."""
    from deeplearning4j_tpu_torch.nn import random

    gen = torch.Generator(device="cuda").manual_seed(seed)
    step_key = random.fold_in(random.host_key(seed), 0)
    drops = [(layer, random.fold_in(step_key, i),
              torch.rand(batch, layer.n_in, device="cuda", generator=gen))
             for i, layer in enumerate(conf.layers) if layer.dropout > 0.0]

    def masks():
        for layer, key, x in drops:
            layer.maybe_dropout(x, train=True, rng=key)
    return graph_ms(torch, masks, reps=3), [tuple(x.shape)
                                             for _, _, x in drops]


def run_alexnet_train(torch, card, records):
    """[alexnet-train] the zoo's AlexNet (224 x 224 x 3, 1000 classes,
    62.4 M parameters, NESTEROVS lr 0.01, dropout 0.5 on both dense
    layers) trained through ``MultiLayerNetwork.fit`` at batch 128 on
    synthetic standardized pixels placed on the card beforehand (raw
    0-255 pixels diverge without a BN: the score went 56 -> 8e6 -> NaN
    in three steps on the CPU): one batch-4 step held against the CPU twin
    from the same state (the masks are integer arithmetic: the twin
    drops the same units; every conv and dense kernel call held to its
    plain version on its operands) and repeated bitwise, one step's
    launches counted exactly, then the main path: a fresh network fits
    2 minibatches of 128 for 3 epochs (6 steps), its training score on
    the first minibatch finite and falling. Prints host and device ms a
    step, the busy share, images/s, peak memory, each kernel's ms a
    step beside its library call (``records``: the ``alexnet-train.``
    kernel records, TF32 off) and the dropout masks' device ms. Returns
    the launch counts of the main path."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn import random
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.zoo import alexnet

    conf = alexnet()
    lr = conf.layers[0].learning_rate
    net = MultiLayerNetwork(conf, device="cuda").init()
    init = {ln: {pn: t.clone() for pn, t in lp.items()}
            for ln, lp in net.params.items()}
    print(f"[alexnet-train] zoo.alexnet() ({net.num_params()} params), "
          f"224x224x3, 1000 classes, NESTEROVS lr {lr}, dropout "
          f"{[layer.dropout for layer in conf.layers if layer.dropout]}, "
          f"batch {ALEXNET_TRAIN_BATCH}, f32, synthetic standardized "
          f"pixels")

    def expect(**counts):
        want = {k: 0 for k in dispatch.KERNELS}
        want.update(counts)
        return want

    # ImageNet-style standardized pixels ((p - 127.5) / 73.9) of uint8
    # draws from a seed, on the card before the timed run
    host = [DataSet((b.features.astype(np.float32) - 127.5) / 73.9,
                    b.labels.astype(np.float32))
            for b in resnet_batches(2, ALEXNET_TRAIN_BATCH, seed=13)]
    batches = [DataSet(torch.from_numpy(b.features).cuda(),
                       torch.from_numpy(b.labels).cuda()) for b in host]
    # the masks on the card and on the CPU from one key: the same bits
    key = random.fold_in(random.fold_in(random.host_key(conf.seed), 0), 9)
    on_card = random.bernoulli(key, 0.5, (ALEXNET_TRAIN_BATCH, 9216),
                               device="cuda")
    if not torch.equal(on_card.cpu(), random.bernoulli(
            key, 0.5, (ALEXNET_TRAIN_BATCH, 9216))):
        raise RuntimeError("[alexnet-train] card and CPU masks differ")
    # one step at batch 4 on the card and on the CPU twin from the same
    # state, on standardized pixels: the score within rtol 1e-4, the
    # weights as check_twin_step, every kernel call held on its operands;
    # then the same step again on the card: the same bits
    small = DataSet(host[0].features[:ALEXNET_TWIN_BATCH],
                    host[0].labels[:ALEXNET_TWIN_BATCH])
    a = MultiLayerNetwork(conf, device="cuda").init(params=init)
    twin = cpu_twin(torch, a)
    before = {ln: {pn: t.cpu() for pn, t in lp.items()}
              for ln, lp in a.params.items()}
    held = held_on_operands(dense=True)
    with held:
        a.fit(small)
    twin.fit(small)
    np.testing.assert_allclose(a.score_value, twin.score_value, rtol=1e-4)
    share = check_twin_step("alexnet-train", a, twin, before)
    if {k: n for k, (n, _) in held.errors.items()} != {
            "conv_block": 10, "conv_bwd_data": 4, "conv_bwd_w": 5,
            "matmul_block": 2}:
        raise RuntimeError(f"[alexnet-train] held calls: {held.errors}")
    again = MultiLayerNetwork(conf, device="cuda").init(params=init)
    again.fit(small)
    torch.cuda.synchronize()
    for ln, lp in a.params.items():
        for pn, t in lp.items():
            if not torch.equal(t, again.params[ln][pn]):
                raise RuntimeError(f"[alexnet-train] two card runs differ "
                                   f"at {ln}/{pn}")
    twin_scores = {"card": a.score_value, "cpu": twin.score_value}
    del a, again, twin

    # one step's launches, exactly: 5 forwards and 5 f32 recomputes, dW
    # of all 5, dx of conv2-conv5 (the stem's input is the data), the
    # two dense relu layers (the softmax head is torch.addmm)
    dispatch.reset_launch_counts()
    net.fit(batches[1])
    torch.cuda.synchronize()
    per_step = dispatch.launch_counts()
    if per_step != expect(conv_block=10, conv_bwd_data=4, conv_bwd_w=5,
                          matmul_block=2):
        raise RuntimeError(f"[alexnet-train] one step launched {per_step}")
    del net

    # the main path: a fresh network fits the minibatches, timed
    model = MultiLayerNetwork(conf, device="cuda").init(params=init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(batches, epochs=ALEXNET_TRAIN_STEPS // len(batches))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    steps = model.iteration_count
    if steps != ALEXNET_TRAIN_STEPS or launches != {
            k: v * steps for k, v in per_step.items()}:
        raise RuntimeError(f"[alexnet-train] {steps} steps launched "
                           f"{launches}")
    peak = torch.cuda.max_memory_allocated()
    # the training score of each minibatch, first and last epoch (the
    # masks change with the iteration, so the same minibatch is scored
    # on other units; the fall is large beside that)
    probe = MultiLayerNetwork(conf, device="cuda").init(params=init)
    scores = [float(probe.fit_minibatch(ds))
              for _ in range(ALEXNET_TRAIN_STEPS // len(batches))
              for ds in batches]
    if not all(np.isfinite(scores)) or not scores[-2] < scores[0]:
        raise RuntimeError(f"[alexnet-train] the score did not fall: "
                           f"{scores}")
    for ln, lp in probe.params.items():
        for pn, t in lp.items():
            if not torch.equal(t, model.params[ln][pn]):
                raise RuntimeError(f"[alexnet-train] two card runs differ "
                                   f"at {ln}/{pn}")
    del probe
    device_ms, top = profiled_device_ms(torch, lambda: model.fit(batches))
    device_ms /= len(batches)
    mask_ms, mask_shapes = dropout_ms(torch, conf, ALEXNET_TRAIN_BATCH)
    ms_per_step = wall / steps * 1e3
    mine = [r for r in records if r["shape_of"].startswith("alexnet-train.")]
    kinds = {}
    for r in mine:
        k = kinds.setdefault(r["kernel"], dict.fromkeys(
            ("kernel_ms", "library_ms", "plain_ms", "bound_ms"), 0.0))
        for key in k:
            k[key] += r[key] * r["launches_per_step"]
    res = {"steps": steps, "batch": ALEXNET_TRAIN_BATCH,
           "examples_per_s": steps * ALEXNET_TRAIN_BATCH / wall,
           "ms_per_step": ms_per_step, "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / ms_per_step,
           "top_device_ms_per_step": {k[:60]: v / len(batches)
                                      for k, v in top.items()},
           "dropout_device_ms_per_step": mask_ms,
           "dropout_shapes": mask_shapes,
           "dropout_share_of_step": mask_ms / device_ms,
           "kernel_ms_per_step": kinds,
           "scores": scores, "max_memory_allocated_gb": peak / 1e9,
           "launches_per_step": {k: v for k, v in per_step.items() if v},
           "twin_scores": twin_scores, "twin_max_share_of_move": share,
           "kernels_on_operands_max_rel_err": {
               k: e for k, (_, e) in held.errors.items()}}
    print(f"[alexnet-train] {json.dumps(res)} card={card}")
    return launches


def run_vgg16(torch, card):
    """[vgg16] the zoo's VGG-16 at full depth and width (f32) as a
    ``ComputationGraph`` on synthetic CIFAR-10: ``output`` on a batch of
    128 held against the CPU twin, one ``fit`` step's launches counted
    exactly, three steps at batch 32 held against the twin and repeated
    bitwise, then the main path: a fresh network fits 4 minibatches of
    128 for 5 epochs (20 NESTEROVS steps at the zoo's lr 0.01) and its
    score on the first must fall. (The untrained VGG-16, no BN, XAVIER
    weights, leaves ln 10 only slowly: over 20 fresh minibatches its
    score moves in the fourth decimal, up or down.) Returns the launch
    counts of the main path (the ``output`` call and the fit)."""
    import warnings

    from deeplearning4j_tpu_torch.datasets import (
        CifarDataSetIterator,
        DataSet,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.zoo import vgg16

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        data = CifarDataSetIterator(VGG_BATCH, allow_synthetic=True,
                                    num_examples=VGG_BATCH * VGG_BATCHES)
    batches = list(data)
    conf = vgg16()
    lr = conf.vertices["conv0"].layer_conf.learning_rate
    net = ComputationGraph(conf, device="cuda").init()
    init = {ln: {pn: t.clone() for pn, t in lp.items()}
            for ln, lp in net.params.items()}
    print(f"[vgg16] zoo.vgg16() as a ComputationGraph ({net.num_params()} "
          f"params), NESTEROVS lr {lr}, MCXENT, batch {VGG_BATCH}, f32, "
          f"synthetic CIFAR-10 ({data.total_examples()} examples)")
    main = {k: 0 for k in dispatch.KERNELS}

    def expect(**counts):
        want = {k: 0 for k in dispatch.KERNELS}
        want.update(counts)
        return want

    # output on one batch against the CPU twin (the plain path); deep f32
    # sums in another order: rtol 1e-3 on the probabilities
    probe = batches[0]
    dispatch.reset_launch_counts()
    out = net.output(probe.features)[0]
    torch.cuda.synchronize()
    per_output = dispatch.launch_counts()
    if per_output != expect(conv_block=13, matmul_block=2):
        raise RuntimeError(f"[vgg16] output launched {per_output}")
    for k, v in per_output.items():
        main[k] += v
    if out.shape != (VGG_BATCH, 10) or not torch.isfinite(out).all():
        raise RuntimeError(f"[vgg16] bad output {tuple(out.shape)}")
    ref = cpu_twin(torch, net).output(probe.features)[0]
    out_err = float((out.cpu() - ref).abs().max())
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-3, atol=1e-6)

    # three steps at batch 32 on the card and on the CPU twin. Momentum
    # SGD moves a weight by lr times its (accumulated) gradient, so
    # gradients that differ in the last bits move the weights apart by
    # far less than lr: scores within rtol 1e-3, every weight within
    # lr / 100, and at most 1 % of any parameter's entries beyond 1e-5 +
    # 1e-3 |w| (a max-pool tie or a relu kink decided the other way)
    small = [DataSet(b.features[:VGG_TWIN_BATCH], b.labels[:VGG_TWIN_BATCH])
             for b in batches[1:4]]
    a = ComputationGraph(conf, device="cuda").init(params=init)
    twin = cpu_twin(torch, a)
    card_scores, cpu_scores = [], []
    for ds in small:
        a.fit(ds)
        twin.fit(ds)
        card_scores.append(a.score_value)
        cpu_scores.append(twin.score_value)
    np.testing.assert_allclose(card_scores, cpu_scores, rtol=1e-3)
    max_diff, max_off = 0.0, 0.0
    for ln, lp in twin.params.items():
        for pn, ref_w in lp.items():
            d = (a.params[ln][pn].cpu() - ref_w).abs()
            off = float((d > 1e-5 + 1e-3 * ref_w.abs()).float().mean())
            max_diff, max_off = max(max_diff, float(d.max())), max(max_off,
                                                                   off)
            if float(d.max()) > lr / 100 or off > 0.01:
                raise RuntimeError(f"[vgg16] card and CPU twin differ at "
                                   f"{ln}/{pn}: max {float(d.max())}, "
                                   f"{off:.2%} off")
    again = ComputationGraph(conf, device="cuda").init(params=init)
    for ds in small:
        again.fit(ds)
    torch.cuda.synchronize()
    for ln, lp in a.params.items():
        for pn, t in lp.items():
            same = torch.equal(t, again.params[ln][pn]) and all(
                torch.equal(u, v) for u, v in zip(
                    a.updater_state[ln][pn], again.updater_state[ln][pn]))
            if not same:
                raise RuntimeError(f"[vgg16] two card runs differ at "
                                   f"{ln}/{pn}")
    del a, again, twin

    # one step's launches, exactly: 13 forwards and 13 f32 recomputes of
    # the convs, dW of all 13, dx of all but conv0 (its input is the
    # data), and the two dense layers' forwards
    dispatch.reset_launch_counts()
    net.fit(batches[1])
    torch.cuda.synchronize()
    per_step = dispatch.launch_counts()
    if per_step != expect(conv_block=26, conv_bwd_data=12, conv_bwd_w=13,
                          matmul_block=2):
        raise RuntimeError(f"[vgg16] one step launched {per_step}")

    # the main path: a fresh network fits the iterator, timed
    model = ComputationGraph(conf, device="cuda").init(params=init)
    del net
    before = model.score(probe)
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(data, epochs=VGG_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    steps = model.iteration_count
    if steps != VGG_BATCHES * VGG_EPOCHS or launches != {k: v * steps
                                          for k, v in per_step.items()}:
        raise RuntimeError(f"[vgg16] {steps} steps launched {launches}")
    for k, v in launches.items():
        main[k] += v
    after = model.score(probe)
    if not np.isfinite(after) or not after < before:
        raise RuntimeError(f"[vgg16] the score did not fall: {before} -> "
                           f"{after}")
    device_ms, top = profiled_device_ms(torch, lambda: model.fit(batches[:2]))
    device_ms /= 2
    ms_per_step = wall / steps * 1e3
    res = {"steps": steps, "epochs": VGG_EPOCHS, "batch": VGG_BATCH,
           "examples_per_s": steps * VGG_BATCH / wall,
           "ms_per_step": ms_per_step, "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / ms_per_step,
           "top_device_ms_per_step": {k[:60]: v / 2 for k, v in top.items()},
           "score_before": before, "score_after": after,
           "launches_per_output": {k: v for k, v in per_output.items() if v},
           "launches_per_step": {k: v for k, v in per_step.items() if v},
           "output_max_abs_err_vs_plain": out_err,
           "twin_scores": {"card": card_scores, "cpu": cpu_scores},
           "twin_max_abs_diff": max_diff, "twin_max_share_off": max_off,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[vgg16] {json.dumps(res)} card={card}")
    return main


def conv_bn_conf():
    """Conv 3x3 pad 1 (identity) -> BatchNormalization(relu) -> max pool
    -> softmax 10 on [b, 64, 32, 32]: VGG-16's first widths."""
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization,
        ConvolutionLayer,
        OutputLayer,
        SubsamplingLayer,
    )

    return (NeuralNetConfiguration.Builder().seed(42).learning_rate(0.01)
            .updater("NESTEROVS").list()
            .layer(ConvolutionLayer(n_out=CONV_BN_CHANNELS,
                                    kernel_size=(3, 3), padding=(1, 1),
                                    activation="identity"))
            .layer(BatchNormalization(activation="relu"))
            .layer(SubsamplingLayer(pooling_type="MAX"))
            .layer(OutputLayer(n_out=10, loss="MCXENT"))
            .set_input_type(InputType.convolutional(
                CONV_BN_HW, CONV_BN_HW, CONV_BN_CHANNELS))
            .build())


def unfused_output(torch, model, x):
    """Inference through a ``MultiLayerNetwork``'s layers one at a time:
    the walk without the conv -> BN fold."""
    from deeplearning4j_tpu_torch.nn.conf import ShapeContext

    conf = model.conf
    ctx = ShapeContext(batch=int(x.shape[0]))
    with torch.inference_mode():
        for i, (name, layer) in enumerate(zip(model.layer_names,
                                              conf.layers)):
            if i in conf.preprocessors:
                x = conf.preprocessors[i].preprocess(x, ctx)
            x, _ = layer.apply(model.params[name], x.contiguous(),
                               model.state[name])
    return x


def run_conv_bn(torch, card):
    """[conv-bn] a MultiLayer Conv(identity) -> BN(relu) block at VGG-16's
    first widths (c 64 -> 64, 32 x 32, batch 128) with nonzero running
    statistics: the inference forward folds the pair into one
    ``conv_block`` launch (counted) and is held against the unfused
    plain path (the CPU twin walked layer by layer); one ``fit`` step
    (no fold) moves the running statistics as the CPU twin's step does.
    Returns the launch counts of the two calls."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import conv_block, dispatch

    net = MultiLayerNetwork(conv_bn_conf(), device="cuda").init()
    rng = np.random.RandomState(3)
    c = CONV_BN_CHANNELS
    net.state["1"] = {
        "mean": torch.from_numpy(rng.randn(c).astype(np.float32) * 0.2).cuda(),
        "var": torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5).cuda()}
    x = torch.from_numpy(rng.rand(CONV_BN_BATCH, c, CONV_BN_HW,
                                  CONV_BN_HW).astype(np.float32)).cuda()
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, CONV_BN_BATCH)]
    twin = cpu_twin(torch, net)
    main = {k: 0 for k in dispatch.KERNELS}
    dispatch.reset_launch_counts()
    out = net.output(x)
    torch.cuda.synchronize()
    fused = dispatch.launch_counts()
    want = {k: 0 for k in dispatch.KERNELS}
    want.update(conv_block=1)
    if fused != want:
        raise RuntimeError(f"[conv-bn] the folded output launched {fused}")
    for k, v in fused.items():
        main[k] += v
    ref = unfused_output(torch, twin, x.cpu())
    err = float((out.cpu() - ref).abs().max())
    # f32 on both sides, the BN affine applied in the epilogue instead of
    # after the store: one rounding less, sums of 576 O(1) products
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-6)
    # the conv -> BN pair alone, folded (one launch) and unfused (the
    # identity conv launch, then the BN layer in plain torch)
    conv, bn = net.conf.layers[0], net.conf.layers[1]
    cp, bp, st = net.params["0"], net.params["1"], net.state["1"]
    a, b = bn.folded_affine(bp, st)
    with torch.inference_mode():
        fused_ms = graph_ms(torch, lambda: conv_block(
            x, cp["W"], cp["b"], a, b, padding=(1, 1), activation="relu"))
        unfused_ms = graph_ms(torch, lambda: bn.apply(bp, conv_block(
            x, cp["W"], cp["b"], padding=(1, 1)), st)[0])
    # one training step: batch statistics, no fold
    dispatch.reset_launch_counts()
    net.fit(DataSet(x, y))
    torch.cuda.synchronize()
    step = dispatch.launch_counts()
    want = {k: 0 for k in dispatch.KERNELS}
    want.update(conv_block=2, conv_bwd_w=1)
    if step != want:
        raise RuntimeError(f"[conv-bn] one step launched {step}")
    for k, v in step.items():
        main[k] += v
    twin.fit(DataSet(x.cpu(), y))
    # the batch statistics average 131,072 values a channel, in another
    # order: rtol 1e-4
    state_err = 0.0
    for k in ("mean", "var"):
        got, ref_s = net.state["1"][k].cpu(), twin.state["1"][k]
        torch.testing.assert_close(got, ref_s, rtol=1e-4, atol=1e-6)
        state_err = max(state_err, float((got - ref_s).abs().max()))
    np.testing.assert_allclose(net.score_value, twin.score_value, rtol=1e-4)
    res = {"batch": CONV_BN_BATCH, "channels": c, "hw": CONV_BN_HW,
           "launches_per_output": {k: v for k, v in fused.items() if v},
           "launches_per_step": {k: v for k, v in step.items() if v},
           "max_abs_err_vs_unfused_plain": err,
           "running_state_max_abs_err_vs_twin": state_err,
           "fused_ms": fused_ms, "unfused_ms": unfused_ms,
           "score": {"card": net.score_value, "cpu": twin.score_value}}
    print(f"[conv-bn] {json.dumps(res)} card={card}")
    return main


def resnet_batches(n_batches, batch, seed):
    """Synthetic ImageNet minibatches from a seed, as bench.py makes
    them: uint8 pixels (cast on the card) and uint8 one-hot labels over
    1000 classes."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    rng = np.random.RandomState(seed)
    return [DataSet(rng.randint(0, 256, (batch, 3, 224, 224), dtype=np.uint8),
                    np.eye(1000, dtype=np.uint8)[rng.randint(0, 1000, batch)])
            for _ in range(n_batches)]


class held_on_operands:
    """Within the block, every call of the three conv kernels (and with
    ``dense`` of the dense kernel and its residual variant) is held
    against its plain version on the same operands on the card:
    ``errors[kernel]`` is (calls, largest error relative to the plain
    result's largest entry), and a call past ``rel`` raises (an f32
    result; a bf16 or f16 one, rounded once to its type on each side,
    past ``HALF_REL`` of its dtype)."""

    def __init__(self, rel: float = 5e-5, dense: bool = False):
        self.rel = rel
        self.dense = dense
        self.errors = {}

    def __enter__(self):
        cb = importlib.import_module(
            "deeplearning4j_tpu_torch.ops.conv_block")
        mb = importlib.import_module(
            "deeplearning4j_tpu_torch.ops.matmul_block")
        self._cb, self._mb = cb, mb
        self._saved = (cb._kernel_forward, cb.conv_bwd_data, cb.conv_bwd_w,
                       mb._kernel_forward)
        kfwd, kdx, kdw, kmm = self._saved

        def held(name, kernel, plain):
            def call(*args):
                got = kernel(*args)
                ref = plain(*args)
                key = name(args) if callable(name) else name
                scale = max(float(ref.float().abs().max()), 1e-30)
                rel = float((got.float() - ref.float()).abs().max()) / scale
                n, worst = self.errors.get(key, (0, 0.0))
                self.errors[key] = (n + 1, max(worst, rel))
                if rel > HALF_REL.get(str(got.dtype), self.rel):
                    raise RuntimeError(f"{key} {tuple(args[0].shape)} "
                                       f"{got.dtype}: {rel:.2e} of the "
                                       "plain result")
                return got
            return call

        cb._kernel_forward = held("conv_block", kfwd, cb._plain_forward)
        cb.conv_bwd_data = held("conv_bwd_data", kdx,
                                cb.conv_bwd_data_reference)
        cb.conv_bwd_w = held("conv_bwd_w", kdw, cb.conv_bwd_w_reference)
        if self.dense:  # args: x, w, bias, residual, activation
            mb._kernel_forward = held(
                lambda args: ("matmul_block" if args[3] is None
                              else "matmul_block_residual"),
                kmm, mb._plain_forward)
        return self

    def __exit__(self, *exc):
        cb, mb = self._cb, self._mb
        (cb._kernel_forward, cb.conv_bwd_data, cb.conv_bwd_w,
         mb._kernel_forward) = self._saved
        return False


def check_twin_step(tag, model, twin, before, share: float = 0.5):
    """The card's weights against the CPU twin's after one step from the
    same state (``before``: the weights both started from): each
    parameter within ``share`` of its largest move in the step, plus
    1e-6. At ResNet-50's init the backward runs through 53 BNs whose
    mean subtraction cancels most of a gradient that the global average
    pool makes nearly constant over a channel, so rounding in the
    forward reaches the weight updates amplified: from the same state,
    card and CPU updates differed by up to 27 % of a parameter's move
    (an H100 80GB HBM3 at 700 W, batch 4), while every conv kernel call
    of the step held its plain version on the same operands within 5e-5
    of scale (``held_on_operands``). Returns the largest share."""
    worst = 0.0
    for ln, lp in twin.params.items():
        for pn, ref_w in lp.items():
            move = float((ref_w - before[ln][pn]).abs().max())
            d = float((model.params[ln][pn].cpu() - ref_w).abs().max())
            if d > share * move + 1e-6:
                raise RuntimeError(f"[{tag}] {ln}/{pn} differs by {d}, "
                                   f"its step moved it {move}")
            if move > 1e-6:
                worst = max(worst, d / move)
    return worst


def run_resnet50(torch, card):
    """[resnet50] the zoo's ResNet-50 at 224 x 224 x 3, 1000 classes,
    full depth and width (f32, NESTEROVS lr 0.01 as bench.py:823) as a
    ``ComputationGraph`` on synthetic uint8 ImageNet batches: ``output``
    at batch 128 against the CPU twin, two steps at batch 4 each held
    against the twin from the same state and repeated bitwise, one step's launches counted exactly, then
    the main path: a fresh network fits 2 minibatches of 128 for 3
    epochs (6 steps) and its training score on the first minibatch must
    fall. Returns the launch counts of the main path and the trained
    network's initial weights."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.zoo import resnet50

    conf = resnet50(learning_rate=0.01)
    lr = 0.01
    net = ComputationGraph(conf, device="cuda").init()
    init = {ln: {pn: t.clone() for pn, t in lp.items()}
            for ln, lp in net.params.items()}
    print(f"[resnet50] zoo.resnet50() as a ComputationGraph "
          f"({net.num_params()} params), 224x224x3, 1000 classes, "
          f"NESTEROVS lr {lr}, batch {RESNET_BATCH}, f32, synthetic uint8 "
          f"pixels")
    main = {k: 0 for k in dispatch.KERNELS}

    def expect(**counts):
        want = {k: 0 for k in dispatch.KERNELS}
        want.update(counts)
        return want

    batches = resnet_batches(2, RESNET_BATCH, seed=11)
    # output at batch 128 against the CPU twin (the plain path): 53 conv
    # launches (the graph engine folds no BN); deep f32 sums in another
    # order: rtol 1e-3 on the probabilities
    probe = batches[0]
    dispatch.reset_launch_counts()
    out = net.output(probe.features)[0]
    torch.cuda.synchronize()
    per_output = dispatch.launch_counts()
    if per_output != expect(conv_block=53):
        raise RuntimeError(f"[resnet50] output launched {per_output}")
    for k, v in per_output.items():
        main[k] += v
    if out.shape != (RESNET_BATCH, 1000) or not torch.isfinite(out).all():
        raise RuntimeError(f"[resnet50] bad output {tuple(out.shape)}")
    ref = cpu_twin(torch, net).output(probe.features)[0]
    out_err = float((out.cpu() - ref).abs().max())
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-3, atol=1e-6)

    # two steps at batch 4 on the card and on the CPU twin, each from
    # the same state (the twin takes the card's weights, velocities and
    # running statistics before each): scores within rtol 1e-4, BN's
    # running statistics (forward sums) within rtol 1e-3, weights as
    # check_twin_step, and every conv kernel call of the card's steps
    # held against its plain version on the same operands. The twin
    # steps take standardized pixels ((p - 127.5) / 73.9, as an ImageNet
    # pipeline feeds them)
    small = [DataSet(((b.features[:RESNET_TWIN_BATCH].astype(np.float32)
                       - 127.5) / 73.9),
                     b.labels[:RESNET_TWIN_BATCH]) for b in batches]
    a = ComputationGraph(conf, device="cuda").init(params=init)
    twin = cpu_twin(torch, a)
    card_scores, cpu_scores = [], []
    worst_share = state_err = 0.0
    held = held_on_operands()
    for ds in small:
        before = {ln: {pn: t.cpu() for pn, t in lp.items()}
                  for ln, lp in a.params.items()}
        twin.params = before
        twin.updater_state = {ln: {pn: tuple(t.cpu() for t in tup)
                                   for pn, tup in lp.items()}
                              for ln, lp in a.updater_state.items()}
        twin.state = {ln: {k: t.cpu() for k, t in st.items()}
                      for ln, st in a.state.items()}
        with held:
            a.fit(ds)
        twin.fit(ds)
        card_scores.append(a.score_value)
        cpu_scores.append(twin.score_value)
        worst_share = max(worst_share,
                          check_twin_step("resnet50", a, twin, before))
        for ln, st in twin.state.items():
            for k, ref_s in st.items():
                got = a.state[ln][k].cpu()
                torch.testing.assert_close(got, ref_s, rtol=1e-3, atol=1e-5)
                state_err = max(state_err, float((got - ref_s).abs().max()))
    np.testing.assert_allclose(card_scores, cpu_scores, rtol=1e-4)
    if {k: n for k, (n, _) in held.errors.items()} != {
            "conv_block": 212, "conv_bwd_data": 104, "conv_bwd_w": 106}:
        raise RuntimeError(f"[resnet50] held calls: {held.errors}")
    again = ComputationGraph(conf, device="cuda").init(params=init)
    for ds in small:
        again.fit(ds)
    torch.cuda.synchronize()
    for ln, lp in a.params.items():
        for pn, t in lp.items():
            if not torch.equal(t, again.params[ln][pn]):
                raise RuntimeError(f"[resnet50] two card runs differ at "
                                   f"{ln}/{pn}")
    del a, again, twin

    # one step's launches, exactly: 53 forwards and 53 f32 recomputes,
    # dW of all 53, dx of all but the stem (its input is the data)
    dispatch.reset_launch_counts()
    net.fit(batches[1])
    torch.cuda.synchronize()
    per_step = dispatch.launch_counts()
    if per_step != expect(conv_block=106, conv_bwd_data=52, conv_bwd_w=53):
        raise RuntimeError(f"[resnet50] one step launched {per_step}")
    del net

    # the main path: a fresh network fits the minibatches, timed
    model = ComputationGraph(conf, device="cuda").init(params=init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    scores = []
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS // len(batches)):
        for ds in batches:
            scores.append(model.fit_minibatch(ds))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    steps = model.iteration_count
    if steps != RESNET_STEPS or launches != {k: v * steps
                                             for k, v in per_step.items()}:
        raise RuntimeError(f"[resnet50] {steps} steps launched {launches}")
    for k, v in launches.items():
        main[k] += v
    peak = torch.cuda.max_memory_allocated()
    scores = [float(s) for s in scores]
    # the training score of the first minibatch, first and last epoch
    if not all(np.isfinite(scores)) or not scores[-2] < scores[0]:
        raise RuntimeError(f"[resnet50] the score did not fall: {scores}")
    device_ms, top = profiled_device_ms(torch, lambda: model.fit(batches))
    device_ms /= 2
    ms_per_step = wall / steps * 1e3
    res = {"steps": steps, "batch": RESNET_BATCH,
           "examples_per_s": steps * RESNET_BATCH / wall,
           "ms_per_step": ms_per_step, "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / ms_per_step,
           "top_device_ms_per_step": {k[:60]: v / 2 for k, v in top.items()},
           "scores": scores, "max_memory_allocated_gb": peak / 1e9,
           "launches_per_output": {k: v for k, v in per_output.items() if v},
           "launches_per_step": {k: v for k, v in per_step.items() if v},
           "output_max_abs_err_vs_plain": out_err,
           "twin_scores": {"card": card_scores, "cpu": cpu_scores},
           "twin_max_share_of_move": worst_share,
           "twin_running_stats_max_abs_err": state_err,
           "kernels_on_operands_max_rel_err": {
               k: e for k, (_, e) in held.errors.items()}}
    print(f"[resnet50] {json.dumps(res)} card={card}")
    return main, init, batches


def run_resnet50_dp(torch, card, init, batches):
    """[resnet50-dp] ``DistributedTrainer(ComputationGraph(resnet50()),
    batch_stats="sync")`` over an NCCL group of world size 1 (formed
    here through a file rendezvous in a temporary directory): three
    steps from the same weights as a plain graph's ``fit_minibatch``,
    held to it bit for bit (scores, weights, running statistics: the
    all-reduces of a world of one add nothing), and one ``zero=True``
    step held bitwise to the replicated step. Returns the launch counts
    of the trainer's steps."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.parallel import (
        DistributedTrainer,
        build_mesh,
        init_distributed,
        shutdown_distributed,
    )
    from deeplearning4j_tpu_torch.zoo import resnet50

    conf = resnet50(learning_rate=0.01)
    steps = 3
    tmp = tempfile.mkdtemp(prefix="dl4j_rdv_")
    main = {k: 0 for k in dispatch.KERNELS}
    try:
        dev = init_distributed(f"file://{tmp}/rdv", 1, 0, device="cuda",
                               timeout_s=120)
        mesh = build_mesh()
        if dist.get_backend() != "nccl" or mesh.backend != "nccl":
            raise RuntimeError(f"[resnet50-dp] formed {dist.get_backend()}")
        print(f"[resnet50-dp] NCCL world of {mesh.data} on {dev}, "
              f"batch_stats='sync', batch {RESNET_BATCH}")
        plain = ComputationGraph(conf, device="cuda").init(params=init)
        plain_scores, plain_ms = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain_scores.append(float(plain.fit_minibatch(
                batches[i % len(batches)])))
            plain_ms.append((time.perf_counter() - t0) * 1e3)
        model = ComputationGraph(conf, device="cuda").init(params=init)
        tr = DistributedTrainer(model, mesh=mesh, batch_stats="sync")
        dp_scores, dp_ms = [], []
        dispatch.reset_launch_counts()
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dp_scores.append(float(tr.fit_minibatch(
                batches[i % len(batches)])))
            dp_ms.append((time.perf_counter() - t0) * 1e3)
        launches = dispatch.launch_counts()
        want = {k: 0 for k in dispatch.KERNELS}
        want.update(conv_block=106 * steps, conv_bwd_data=52 * steps,
                    conv_bwd_w=53 * steps)
        if launches != want:
            raise RuntimeError(f"[resnet50-dp] {steps} steps launched "
                               f"{launches}")
        for k, v in launches.items():
            main[k] += v
        if any(t.device.type != "cuda" for lp in model.params.values()
               for t in lp.values()):
            raise RuntimeError("[resnet50-dp] a parameter left the card")
        # a world of one: the all-reduces add nothing and BN's statistics
        # are the same sums over the same count, so the same bits
        same = dp_scores == plain_scores and all(
            torch.equal(t, plain.params[ln][pn])
            for ln, lp in model.params.items() for pn, t in lp.items()
        ) and all(torch.equal(t, plain.state[ln][k])
                  for ln, st in model.state.items() for k, t in st.items())
        if not same:
            raise RuntimeError("[resnet50-dp] the trainer's steps differ "
                               "from the plain graph's")
        del plain, model, tr
        # one step with ZeRO-1 against the replicated step, from the
        # same weights: the same bits (every updater rule is elementwise)
        pair = []
        for zero in (False, True):
            g = ComputationGraph(conf, device="cuda").init(params=init)
            t = DistributedTrainer(g, mesh=mesh, batch_stats="sync",
                                   zero=zero)
            s = float(t.fit_minibatch(batches[0]))
            pair.append((g, t, s))
        (rep, _, s_rep), (zro, ztr, s_zero) = pair
        if s_rep != s_zero or any(
                not torch.equal(t, zro.params[ln][pn])
                for ln, lp in rep.params.items() for pn, t in lp.items()):
            raise RuntimeError("[resnet50-dp] zero=True differs from the "
                               "replicated step")
        res = {"world": mesh.data, "backend": mesh.backend,
               "batch": RESNET_BATCH, "steps": steps,
               "scores": dp_scores, "plain_scores": plain_scores,
               "trainer_ms_per_step": dp_ms, "plain_ms_per_step": plain_ms,
               "bitwise_vs_plain": True, "zero_bitwise": True,
               "updater_state_bytes_per_device":
                   ztr.updater_state_bytes_per_device,
               "zero_shard_bytes": ztr.zero_shard_bytes,
               "launches_per_step": {k: v // steps for k, v in
                                     launches.items() if v}}
        print(f"[resnet50-dp] {json.dumps(res)} card={card}")
    finally:
        shutdown_distributed()
        shutil.rmtree(tmp, ignore_errors=True)
    return main


# --- half-precision training (the mixed-precision slice) -------------------

# a half (bf16 / f16) kernel output against its plain version, relative
# to the plain result's largest entry: each output rounds once to the
# half type, and the two sum the same exact products in other orders,
# so they differ by at most one rounding of the type (2**-8 / 2**-11)
HALF_REL = {"torch.bfloat16": 8e-3, "torch.float16": 1e-3}
HALF_TWIN_RTOL, HALF_TWIN_ATOL = 2e-2, 8e-3  # bf16 scores, card vs CPU


def check_half_kernels(torch, F, gen):
    """The conv kernels' half-precision variants at every distinct conv
    shape of a ResNet-50 training step (224 x 224, batch 128) in bf16:
    the forward half in / half out (each layer's launch), half in / f32
    out (the backward's recompute of the accumulator), and dW on a half
    image with the f32 dacc; each against its plain version on the same
    operands, repeated bitwise, timed (CUDA graphs) beside the plain
    version and the library's bf16 call (``F.conv2d``,
    ``torch.nn.grad.conv2d_weight`` with a bf16 gradient; cuDNN, on
    tensor cores). ``bound_ms`` is at the tensor-core rate of the
    operands' type: bf16 for the forward (both operands bf16), TF32 for
    dW (its dacc is f32); ``bound_fp32_simt_ms`` beside it is at the
    FP32 rate outside the tensor cores, what the SIMT kernels can
    reach."""
    cb = importlib.import_module("deeplearning4j_tpu_torch.ops.conv_block")
    dtype, tag = torch.bfloat16, "bf16"
    dev = torch.device("cuda")
    f32 = torch.float32
    records = []
    for name, kind, geo, names in resnet_shapes():
        if kind not in ("conv_block", "conv_bwd_w"):
            continue
        xs, ws = tuple(geo["x"]), tuple(geo["w"])
        st, pad = tuple(geo["stride"]), tuple(geo["padding"])
        n, c = xs[:2]
        o, _, kh, kw = ws
        oh, ow = conv_out(xs[2], kh, st[0], pad[0]), conv_out(xs[3], kw, st[1],
                                                             pad[1])
        x = torch.randn(xs, device=dev, generator=gen).to(dtype)
        w = (torch.randn(ws, device=dev, generator=gen)
             / (c * kh * kw) ** 0.5).to(dtype)
        if kind == "conv_block":
            act = geo["activation"]
            one = torch.ones(o, device=dev)
            zero = torch.zeros(o, device=dev)
            flops = 2.0 * n * o * oh * ow * c * kh * kw
            variants = ((tag, dtype), (f"{tag}->f32", f32))
            peak = PEAK_BF16_FLOPS
        else:
            dacc = torch.randn((n, o, oh, ow), device=dev, generator=gen)
            dacc_h = dacc.to(dtype)
            flops = 2.0 * useful_macs(geo)
            variants = ((tag, f32),)
            peak = PEAK_TF32_FLOPS
        for variant, out_dtype in variants:
            if kind == "conv_block":
                def kernel(out_dtype=out_dtype):
                    return cb._kernel_forward(x, w, one, zero, st, pad, act,
                                              out_dtype)

                def plain(out_dtype=out_dtype):
                    return cb._plain_forward(x, w, one, zero, st, pad, act,
                                             out_dtype)

                def library():
                    return F.conv2d(x, w, stride=st, padding=pad)
                out_elems = n * o * oh * ow
                nbytes = (x.element_size() * (x.numel() + w.numel())
                          + out_elems * (2 if out_dtype == dtype else 4))
                route = cb.conv_block_route(*xs, o, kh, kw, st, pad,
                                            dtype).route
            else:
                def kernel():
                    return cb.conv_bwd_w(x, dacc, ws, st, pad)

                def plain():
                    return cb.conv_bwd_w_reference(x, dacc, ws, st, pad)

                def library():
                    return torch.nn.grad.conv2d_weight(x, ws, dacc_h,
                                                       stride=st,
                                                       padding=pad)
                nbytes = (x.element_size() * x.numel() + 4 * dacc.numel()
                          + 4 * w.numel())
                route = cb.conv_bwd_w_route(*xs, o, kh, kw, st, pad).route
            with torch.inference_mode():
                got, again, ref = kernel(), kernel(), plain()
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise RuntimeError(f"{kind}[{variant}] resnet50.{name}: "
                                       "two launches differ")
                if got.dtype != out_dtype:
                    raise RuntimeError(f"{kind}[{variant}] wrote {got.dtype}")
                err = float((got.float() - ref.float()).abs().max())
                scale = max(float(ref.float().abs().max()), 1e-30)
                rel = HALF_REL[str(dtype)] if out_dtype == dtype else 5e-5
                if err > rel * max(scale, 1.0):
                    raise RuntimeError(f"{kind}[{variant}] resnet50.{name}: "
                                       f"{err} against scale {scale}")
                ms = graph_ms(torch, kernel)
                plain_ms = graph_ms(torch, plain)
                library_ms = graph_ms(torch, library)
            bound_ms, bound_by = bound(flops, nbytes, peak)
            records.append({
                "kernel": kind, "variant": variant, "kernel_route": route,
                "shape_of": f"resnet50.{name}", "x": list(xs), "w": list(ws),
                "stride": list(st), "padding": list(pad),
                "max_abs_err": err, "rel_err": err / scale,
                "kernel_ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "bound_fp32_simt_ms": bound(flops, nbytes)[0],
                "gflop": flops / 1e9, "mb": nbytes / 1e6,
                "launches_per_step": len(names)})
    return records


def snapshot(model):
    """Copies on the device of every parameter, updater moment and layer
    state tensor of ``model``, keyed ``"kind:layer/name/i"``."""
    import torch

    out = {}
    for kind, tree in (("p", model.params), ("u", model.updater_state),
                       ("s", model.state)):
        for ln, lp in tree.items():
            for k, v in lp.items():
                for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
                    if torch.is_tensor(t):
                        out[f"{kind}:{ln}/{k}/{i}"] = t.clone()
    return out


def unchanged(before, model) -> bool:
    """Every tensor of ``before`` (``snapshot``) bitwise equal to the
    model's now."""
    import torch

    now = snapshot(model)
    return now.keys() == before.keys() and all(
        torch.equal(now[k], before[k]) for k in before)


def expect_variants(counts, want):
    """``counts`` (``dispatch.variant_counts()``), checked to be exactly
    ``want`` (``{"kernel[variant]": launches}``)."""
    if counts != want:
        raise RuntimeError(f"launched {counts}, expected {want}")
    return counts


def run_resnet50_bf16(torch, card):
    """[resnet50-bf16] bench.py:824-845's configuration: the zoo's
    ResNet-50 in pure bf16 (parameters, velocities, activations;
    BatchNormalization's statistics f32), NESTEROVS lr 0.01, batch 128 x
    224 x 224 x 3, 1000 classes, synthetic uint8 pixels. Two steps at
    batch 4 held against the CPU twin from the same state, with every
    conv kernel call held against its plain version on its own operands;
    then the main path: a fresh network fits 2 minibatches of 128 for 3
    epochs (6 steps; bench.py: 4 epochs x 2), launches exact by dtype
    variant, the score on the first minibatch falling. Returns the
    launch counts and variant counts of the main path."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.zoo import resnet50

    conf = resnet50(dtype="bfloat16", learning_rate=0.01)
    init_net = ComputationGraph(conf, device="cuda").init()
    init = {ln: {pn: t.clone() for pn, t in lp.items()}
            for ln, lp in init_net.params.items()}
    print(f"[resnet50-bf16] zoo.resnet50(dtype='bfloat16') "
          f"({init_net.num_params()} params), NESTEROVS lr 0.01, batch "
          f"{RESNET_BATCH}, synthetic uint8 pixels")
    del init_net
    batches = resnet_batches(2, RESNET_BATCH, seed=12)
    small = [DataSet(((b.features[:RESNET_TWIN_BATCH].astype(np.float32)
                       - 127.5) / 73.9),
                     b.labels[:RESNET_TWIN_BATCH]) for b in batches]
    a = ComputationGraph(conf, device="cuda").init(params=init)
    twin = cpu_twin(torch, a)
    card_scores, cpu_scores = [], []
    held = held_on_operands()
    for ds in small:
        twin.params = {ln: {pn: t.cpu() for pn, t in lp.items()}
                       for ln, lp in a.params.items()}
        twin.updater_state = {ln: {pn: tuple(t.cpu() for t in tup)
                                   for pn, tup in lp.items()}
                              for ln, lp in a.updater_state.items()}
        twin.state = {ln: {k: t.cpu() for k, t in st.items()}
                      for ln, st in a.state.items()}
        with held:
            a.fit(ds)
        twin.fit(ds)
        card_scores.append(a.score_value)
        cpu_scores.append(twin.score_value)
    # the same bf16 weights and pixels: the scores agree to bf16 rounding
    np.testing.assert_allclose(card_scores, cpu_scores, rtol=HALF_TWIN_RTOL,
                               atol=HALF_TWIN_ATOL)
    if {k: n for k, (n, _) in held.errors.items()} != {
            "conv_block": 212, "conv_bwd_data": 104, "conv_bwd_w": 106}:
        raise RuntimeError(f"[resnet50-bf16] held calls: {held.errors}")
    del a, twin

    model = ComputationGraph(conf, device="cuda").init(params=init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    scores = []
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS // len(batches)):
        for ds in batches:
            scores.append(model.fit_minibatch(ds))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = model.iteration_count
    launches = dispatch.launch_counts()
    variants = expect_variants(dispatch.variant_counts(), {
        "conv_block[bf16]": 53 * steps, "conv_block[bf16->f32]": 53 * steps,
        "conv_bwd_data[f32]": 52 * steps, "conv_bwd_w[bf16]": 53 * steps})
    peak = torch.cuda.max_memory_allocated()
    if any(t.dtype != torch.bfloat16 for lp in model.params.values()
           for t in lp.values()):
        raise RuntimeError("[resnet50-bf16] a parameter is not bf16")
    scores = [float(s) for s in scores]
    if not all(np.isfinite(scores)) or not scores[-2] < scores[0]:
        raise RuntimeError(f"[resnet50-bf16] the score did not fall: "
                           f"{scores}")
    device_ms, top = profiled_device_ms(torch, lambda: model.fit(batches))
    device_ms /= 2
    ms_per_step = wall / steps * 1e3
    res = {"steps": steps, "batch": RESNET_BATCH,
           "examples_per_s": steps * RESNET_BATCH / wall,
           "ms_per_step": ms_per_step, "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / ms_per_step,
           "top_device_ms_per_step": {k[:60]: v / 2 for k, v in top.items()},
           "scores": scores, "max_memory_allocated_gb": peak / 1e9,
           "launches_per_step_by_variant": {k: v // steps
                                            for k, v in variants.items()},
           "twin_scores": {"card": card_scores, "cpu": cpu_scores},
           "kernels_on_operands_max_rel_err": {
               k: e for k, (_, e) in held.errors.items()}}
    print(f"[resnet50-bf16] {json.dumps(res)} card={card}")
    return launches, variants


def run_vgg16_bf16(torch, card):
    """[vgg16-bf16] bench.py:470-480's configuration: the zoo's VGG-16
    in pure bf16, NESTEROVS, batch 128 of synthetic CIFAR-10, 4
    minibatches x 2 epochs (cut from bench.py's epochs). One step with
    every conv and dense kernel call held against its plain version on
    its own operands, then the main path, launches exact by dtype variant.
    Returns the launch counts and variant counts of the main path."""
    import warnings

    from deeplearning4j_tpu_torch.datasets import CifarDataSetIterator
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.zoo import vgg16

    epochs = 2
    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        data = CifarDataSetIterator(VGG_BATCH, allow_synthetic=True,
                                    num_examples=VGG_BATCH * VGG_BATCHES)
    batches = list(data)
    conf = vgg16(dtype="bfloat16")
    net = ComputationGraph(conf, device="cuda").init()
    init = {ln: {pn: t.clone() for pn, t in lp.items()}
            for ln, lp in net.params.items()}
    print(f"[vgg16-bf16] zoo.vgg16(dtype='bfloat16') ({net.num_params()} "
          f"params), NESTEROVS, batch {VGG_BATCH}, synthetic CIFAR-10")
    held = held_on_operands(dense=True)
    with held:
        net.fit(batches[0])
    if {k: n for k, (n, _) in held.errors.items()} != {
            "conv_block": 26, "conv_bwd_data": 12, "conv_bwd_w": 13,
            "matmul_block": 2}:
        raise RuntimeError(f"[vgg16-bf16] held calls: {held.errors}")
    del net
    model = ComputationGraph(conf, device="cuda").init(params=init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(data, epochs=epochs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = model.iteration_count
    launches = dispatch.launch_counts()
    variants = expect_variants(dispatch.variant_counts(), {
        "conv_block[bf16]": 13 * steps, "conv_block[bf16->f32]": 13 * steps,
        "conv_bwd_data[f32]": 12 * steps, "conv_bwd_w[bf16]": 13 * steps,
        "matmul_block[bf16]": 2 * steps})
    if steps != VGG_BATCHES * epochs or not np.isfinite(model.score_value):
        raise RuntimeError(f"[vgg16-bf16] {steps} steps, score "
                           f"{model.score_value}")
    device_ms, top = profiled_device_ms(torch, lambda: model.fit(batches[:2]))
    device_ms /= 2
    ms_per_step = wall / steps * 1e3
    res = {"steps": steps, "epochs": epochs, "batch": VGG_BATCH,
           "examples_per_s": steps * VGG_BATCH / wall,
           "ms_per_step": ms_per_step, "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / ms_per_step,
           "top_device_ms_per_step": {k[:60]: v / 2 for k, v in top.items()},
           "score": model.score_value,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step_by_variant": {k: v // steps
                                            for k, v in variants.items()},
           "kernels_on_operands_max_rel_err": {
               k: e for k, (_, e) in held.errors.items()}}
    print(f"[vgg16-bf16] {json.dumps(res)} card={card}")
    return launches, variants


def run_transformer_bf16(torch, card, ids):
    """[transformer-bf16] bench.py:866-881's configuration: the
    transformer LM at full width (d 768, 12 layers, 12 heads) with bf16
    compute over f32 master weights (``compute_dtype="bfloat16"``), Adam
    lr 3e-4, batch 16 x t 512 of SURVEY.md's bytes, 20 steps: tokens/s,
    host and device ms a step; the masters and the Adam moments stay
    f32, the activations are bf16, and the flash-attention and dense
    kernels launch in bf16 (by dtype variant). Returns the launch counts
    and variant counts of the run."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.zoo import transformer_lm

    net = MultiLayerNetwork(transformer_lm(compute_dtype="bfloat16", **TX),
                            device="cuda").init()
    layers = TX["n_layers"]
    batches = char_batches(ids, TX_BATCH, TX_T, TX_STEPS, seed=6,
                           vocab=TX["vocab"])
    print(f"[transformer-bf16] transformer_lm({TX}, compute_dtype="
          f"'bfloat16') ({net.num_params()} params), Adam, batch "
          f"{TX_BATCH} x t {TX_T}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    scores = []
    t0 = time.perf_counter()
    for ds in batches:
        net.fit(ds)
        scores.append(net.score_value)  # waits for the card
    wall = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    variants = expect_variants(dispatch.variant_counts(), {
        "flash_attention[bf16]": layers * TX_STEPS,
        "matmul_block[bf16]": TX_STEPS,
        "matmul_block_residual[bf16]": layers * TX_STEPS})
    if not all(np.isfinite(scores)):
        raise RuntimeError(f"[transformer-bf16] a score is not finite: "
                           f"{scores}")
    for ln, lp in net.params.items():
        for pn, t in lp.items():
            if t.dtype != torch.float32 or any(
                    m.dtype != torch.float32
                    for m in net.updater_state[ln][pn]):
                raise RuntimeError(f"[transformer-bf16] {ln}/{pn}: the "
                                   "master or a moment is not f32")
    out = net.output(batches[0].features[:2])
    if out.dtype != torch.bfloat16:
        raise RuntimeError(f"[transformer-bf16] the output is {out.dtype}")
    device_ms, top = profiled_device_ms(torch, lambda: net.fit(batches[:2]))
    device_ms /= 2
    ms_per_step = wall / TX_STEPS * 1e3
    res = {"steps": TX_STEPS, "batch": TX_BATCH, "t": TX_T,
           "tokens_per_s": TX_STEPS * TX_BATCH * TX_T / wall,
           "ms_per_step": ms_per_step, "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / ms_per_step,
           "top_device_ms_per_step": {k[:60]: v / 2 for k, v in top.items()},
           "scores": scores, "output_dtype": str(out.dtype),
           "launches_per_step_by_variant": {
               k: v // TX_STEPS for k, v in variants.items()},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[transformer-bf16] {json.dumps(res)} card={card}")
    return launches, variants


F16_STEPS = 12
F16_SCALE = 2.0 ** 24


def run_f16_loss_scale(torch, card, ids):
    """[f16-loss-scale] the transformer LM at [transformer-bf16]'s width
    in f16 compute with dynamic loss scaling from an initial scale of
    2**24 (set so that the first steps overflow the f16 gradients), 12
    Adam steps: the (scale, good_steps, overflows) sequence; on each
    overflow step the parameters, the Adam moments and the layer state
    are bitwise unchanged and the scale halves; on each clean step the
    count rises; at least one clean step follows the overflows. The
    first step's dense-kernel calls (every f16 product shape of the
    step) are held against their plain version on their own operands.
    Returns the launch counts and variant counts of the run."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.zoo import transformer_lm

    net = MultiLayerNetwork(transformer_lm(
        compute_dtype="float16", loss_scale=F16_SCALE, **TX),
        device="cuda").init()
    if not net._loss_scale_active:
        raise RuntimeError("[f16-loss-scale] loss scaling is not active")
    batches = char_batches(ids, TX_BATCH, TX_T, F16_STEPS, seed=7,
                           vocab=TX["vocab"])
    print(f"[f16-loss-scale] transformer_lm({TX}, compute_dtype='float16', "
          f"loss_scale=2**24), Adam, batch {TX_BATCH} x t {TX_T}")
    layers = TX["n_layers"]
    dispatch.reset_launch_counts()
    seq, scores = [], []
    prev = (F16_SCALE, 0, 0)
    held = held_on_operands(dense=True)
    for i, ds in enumerate(batches):
        before = snapshot(net)
        if i == 0:
            with held:
                net.fit(ds)
            torch.cuda.synchronize()
            t0 = time.perf_counter()  # the held step is not timed
        else:
            net.fit(ds)
        st = net._loss_scale_state
        now = (float(st["scale"]), int(st["good_steps"]),
               int(st["overflows"]))
        if now[2] == prev[2] + 1:  # an overflow: skipped, scale halved
            if not unchanged(before, net) or now[:2] != (prev[0] / 2, 0):
                raise RuntimeError(f"[f16-loss-scale] overflow step "
                                   f"{len(seq)}: {prev} -> {now}")
        elif now != (prev[0], prev[1] + 1, prev[2]):
            raise RuntimeError(f"[f16-loss-scale] clean step {len(seq)}: "
                               f"{prev} -> {now}")
        seq.append(now)
        scores.append(net.score_value)
        prev = now
    wall = time.perf_counter() - t0
    del before
    launches = dispatch.launch_counts()
    variants = expect_variants(dispatch.variant_counts(), {
        "flash_attention[f16]": layers * F16_STEPS,
        "matmul_block[f16]": F16_STEPS,
        "matmul_block_residual[f16]": layers * F16_STEPS})
    if {k: n for k, (n, _) in held.errors.items()} != {
            "matmul_block": 1, "matmul_block_residual": layers}:
        raise RuntimeError(f"[f16-loss-scale] held calls: {held.errors}")
    first_clean = next((i for i, s in enumerate(seq) if s[1] > 0), None)
    if seq[0][2] != 1 or first_clean is None:
        raise RuntimeError(f"[f16-loss-scale] no overflow first or no clean "
                           f"step after: {seq}")
    if not np.isfinite(scores[-1]):
        raise RuntimeError(f"[f16-loss-scale] scores {scores}")
    res = {"steps": F16_STEPS, "initial_scale": F16_SCALE,
           "loss_scale_sequence": seq, "overflows": seq[-1][2],
           "first_clean_step": first_clean, "scores": scores,
           "ms_per_step": wall / (F16_STEPS - 1) * 1e3,
           "launches_per_step_by_variant": {
               k: v // F16_STEPS for k, v in variants.items()},
           "dense_on_operands_max_rel_err": {
               k: e for k, (_, e) in held.errors.items()}}
    print(f"[f16-loss-scale] {json.dumps(res)} card={card}")
    return launches, variants


GUARD_STEPS = 20
MEGASTEP_K = 6  # bench.py:1541-1543
MEGASTEP_LENET_STEPS = 48
MEGASTEP_ALEX_K = 4
MEGASTEP_ALEX_STEPS = 8
GUARD_NAN_STEP = 8
GUARD_SPIKE_STEP = 14
# the anomalous minibatch's one-hot labels scaled by this: its loss and
# gradients that many times a clean step's (x50 hid under the running
# mean of the still-falling loss on the card: 14 steps in, LeNet-5's
# loss is ~0.02)
GUARD_SPIKE = 1000.0


def guard_batches(steps=GUARD_STEPS):
    """[train]'s synthetic MNIST minibatches (batch 256) with minibatch
    GUARD_NAN_STEP poisoned by a NaN and GUARD_SPIKE_STEP's one-hot
    labels scaled by GUARD_SPIKE (a loss spike)."""
    import warnings

    from deeplearning4j_tpu_torch.datasets import (
        DataSet,
        MnistDataSetIterator,
    )

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        data = MnistDataSetIterator(LENET_TRAIN_BATCH, allow_synthetic=True,
                                    num_examples=LENET_TRAIN_BATCH * steps)
    batches = list(data)
    x = batches[GUARD_NAN_STEP].features.copy()
    x[3, 100] = np.nan
    batches[GUARD_NAN_STEP] = DataSet(x, batches[GUARD_NAN_STEP].labels)
    batches[GUARD_SPIKE_STEP] = DataSet(
        batches[GUARD_SPIKE_STEP].features,
        batches[GUARD_SPIKE_STEP].labels * GUARD_SPIKE)
    return batches


def guard_stats():
    """[guard]'s ``StatGuardConfig``: the loss falls fast at lr 0.01, so
    a z-score trip would flag good steps; the spike test (10x the
    running mean) does the work."""
    from deeplearning4j_tpu_torch.resilience.guard import StatGuardConfig

    return StatGuardConfig(alpha=0.1, z_threshold=50.0, spike_factor=10.0,
                           warmup=5)


def run_guard(torch, card, device="cuda", steps=GUARD_STEPS, dense=None):
    """[guard] [train]'s LeNet-5 run (Adam lr 0.01, batch 256, synthetic
    MNIST) under ``DivergenceGuard("skip")`` with a ``StatGuardConfig``,
    20 steps: minibatch 8 poisoned with a NaN and minibatch 14 anomalous
    (its one-hot labels scaled by GUARD_SPIKE: a loss spike). Both bad steps
    leave the parameters, the Adam moments and the layer state bitwise
    unchanged and are the guard's skipped steps; the other steps train
    (the score falls). The guarded step's device time (CUDA-graph
    replays) beside the unguarded step's. Returns the launch counts of
    the run. ``device`` / ``steps`` / ``dense`` cut it for a rehearsal
    on the CPU."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.resilience.guard import DivergenceGuard
    from deeplearning4j_tpu_torch.zoo import lenet

    batches = guard_batches(steps)
    conf = lenet() if dense is None else lenet(dense_width=dense)
    net = MultiLayerNetwork(conf, device=device).init()
    cfg = guard_stats()
    guard = DivergenceGuard("skip", stats=cfg)
    net.set_divergence_guard(guard)
    print(f"[guard] LeNet-5 ({net.num_params()} params), Adam, batch "
          f"{LENET_TRAIN_BATCH}, DivergenceGuard('skip', stats={cfg}); NaN "
          f"at step {GUARD_NAN_STEP}, labels x{GUARD_SPIKE:g} at step "
          f"{GUARD_SPIKE_STEP}")
    dispatch.reset_launch_counts()
    scores, kept = [], []
    t0 = time.perf_counter()
    for i, ds in enumerate(batches):
        bad = i in (GUARD_NAN_STEP, GUARD_SPIKE_STEP)
        before = snapshot(net) if bad else None
        net.fit(ds)
        if bad and not unchanged(before, net):
            raise RuntimeError(f"[guard] bad step {i} changed the model")
        scores.append(net.score_value)
        kept.append(not bad)
    wall = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    if guard.skipped_batches != [GUARD_NAN_STEP, GUARD_SPIKE_STEP]:
        raise RuntimeError(f"[guard] skipped {guard.skipped_batches}")
    clean = [s for s, k in zip(scores, kept) if k]
    if not (np.isfinite(clean).all() and clean[-1] < 0.5 * clean[0]):
        raise RuntimeError(f"[guard] training did not go on: {scores}")
    # one step's device time, guarded and not, from CUDA-graph replays
    res = {"steps": steps, "skipped_batches": guard.skipped_batches,
           "skipped_steps": guard.skipped_steps, "metrics": guard.metrics,
           "stat_guard_state": {k: float(v) for k, v in
                                net._stat_guard_state.items()},
           "scores": scores, "ms_per_step": wall / steps * 1e3}
    if device == "cuda":
        x = torch.from_numpy(batches[0].features).cuda()
        y = torch.from_numpy(batches[0].labels).cuda()
        lrs = net.updater_def.scheduled_lrs(net.iteration_count)
        t = net.iteration_count + 1
        guarded = net._train_step()
        sg = net._stat_guard_state
        net.set_divergence_guard(None)
        plain = net._train_step()
        res["guarded_device_ms_per_step"] = graph_ms(torch, lambda: guarded(
            net.params, net.updater_state, net.state, x, y, None, lrs, t,
            sg=sg), reps=3)
        res["unguarded_device_ms_per_step"] = graph_ms(torch, lambda: plain(
            net.params, net.updater_state, net.state, x, y, None, lrs, t),
            reps=3)
    print(f"[guard] {json.dumps(res)} card={card}")
    return launches


def narrow_alexnet():
    """AlexNet's geometry (11x11/s4/p2, 5x5/p2, three 3x3/p1, 3x3/s2
    pools) on a 67x67x3 input at 8/16/16/16/8 channels, two dense 32
    relu layers with dropout 0.5 and a softmax 10 (the CPU tests'
    ``narrow_alexnet``)."""
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer,
        DenseLayer,
        OutputLayer,
        SubsamplingLayer,
    )

    def pool():
        return SubsamplingLayer(pooling_type="MAX", kernel_size=(3, 3),
                                stride=(2, 2))

    b = (NeuralNetConfiguration.Builder().seed(11).updater("NESTEROVS")
         .list()
         .layer(ConvolutionLayer(n_out=8, kernel_size=(11, 11),
                                 stride=(4, 4), padding=(2, 2),
                                 activation="relu"))
         .layer(pool())
         .layer(ConvolutionLayer(n_out=16, kernel_size=(5, 5),
                                 padding=(2, 2), activation="relu"))
         .layer(pool()))
    for n_out in (16, 16, 8):
        b = b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                     padding=(1, 1), activation="relu"))
    return (b.layer(pool())
            .layer(DenseLayer(n_out=32, activation="relu", dropout=0.5))
            .layer(DenseLayer(n_out=32, activation="relu", dropout=0.5))
            .layer(OutputLayer(n_out=10, loss="MCXENT"))
            .set_input_type(InputType.convolutional(67, 67, 3))
            .build())


def same_trees(torch, a, b) -> bool:
    """Parameters, updater state and layer state of two models, bitwise."""
    return (all(torch.equal(t, b.params[ln][pn])
                for ln, lp in a.params.items() for pn, t in lp.items())
            and all(torch.equal(x, y)
                    for ln, lp in a.updater_state.items()
                    for pn, tup in lp.items()
                    for x, y in zip(tup, b.updater_state[ln][pn]))
            and all(torch.equal(t, b.state[ln][k])
                    for ln, st in a.state.items() for k, t in st.items()))


def run_megastep(torch, card):
    """[megastep] ``fit(megastep=K)`` on the card, each full chunk one
    CUDA-graph replay with one readback, against the per-step loop:
    [train]'s LeNet-5 (Adam lr 0.01, batch 256) over 48 minibatches a
    epoch, per step and at K = 6 (bench.py's K), two epochs each (the
    first captures the chunk; the second is timed): the trees bitwise
    equal, 8 readbacks an epoch, host ms a step and the busy share both
    ways (the device work a step from the chunk's replay over K); the
    narrow AlexNet with dropout 0.5 at K = 4 over 8 minibatches, bitwise
    equal to its per-step run (the chunk derives its keys on the device);
    [guard]'s poisoned LeNet run under K = 6 with the SKIP guard and its
    statistical guard: the same skipped steps and the same trees as per
    step. Returns the launch counts of the phase (counted at capture,
    where Python runs, and on the per-step runs)."""
    import warnings

    from deeplearning4j_tpu_torch.datasets import (
        DataSet,
        MnistDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn import core
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.resilience.guard import DivergenceGuard
    from deeplearning4j_tpu_torch.zoo import lenet

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        data = MnistDataSetIterator(
            LENET_TRAIN_BATCH, allow_synthetic=True,
            num_examples=LENET_TRAIN_BATCH * MEGASTEP_LENET_STEPS)
    batches = list(data)
    conf = lenet()
    init = MultiLayerNetwork(conf, device="cuda").init().params
    readbacks = []
    real_readback = core.megastep_readback

    def counted(*args):
        readbacks.append(args[0].k)
        return real_readback(*args)

    print(f"[megastep] LeNet-5, Adam, batch {LENET_TRAIN_BATCH}, "
          f"{MEGASTEP_LENET_STEPS} minibatches an epoch, per step and at "
          f"megastep={MEGASTEP_K}")
    dispatch.reset_launch_counts()
    runs = {}
    core.megastep_readback = counted
    try:
        for k in (1, MEGASTEP_K):
            net = MultiLayerNetwork(conf, device="cuda").init(params=init)
            net.fit(batches, megastep=k)  # the first epoch captures
            torch.cuda.synchronize()
            n0 = len(readbacks)
            t0 = time.perf_counter()
            net.fit(batches)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[k] = (net, wall / MEGASTEP_LENET_STEPS * 1e3,
                       len(readbacks) - n0)
    finally:
        core.megastep_readback = real_readback
    per_step, mega = runs[1][0], runs[MEGASTEP_K][0]
    if not same_trees(torch, per_step, mega):
        raise RuntimeError("[megastep] LeNet: the chunks differ from the "
                           "per-step loop")
    want = MEGASTEP_LENET_STEPS // MEGASTEP_K
    if runs[MEGASTEP_K][2] != want or runs[1][2] != 0:
        raise RuntimeError(f"[megastep] readbacks an epoch: "
                           f"{runs[MEGASTEP_K][2]}, expected {want}")
    if len(mega._megastep_graphs) != 1:
        raise RuntimeError(f"[megastep] {len(mega._megastep_graphs)} "
                           "captures, expected 1")
    # the device work a step: the captured chunk replayed, over K (this
    # trains the chunk's model on; nothing reads it afterwards)
    g = next(iter(mega._megastep_graphs.values()))
    chunk_ms, _ = events_ms(torch, g.graph.replay, reps=10)
    dev_ms = chunk_ms / MEGASTEP_K
    lenet_res = {
        "steps": MEGASTEP_LENET_STEPS, "k": MEGASTEP_K,
        "device_ms_per_step": dev_ms, "chunk_device_ms": chunk_ms,
        "per_step_host_ms_per_step": runs[1][1],
        "megastep_host_ms_per_step": runs[MEGASTEP_K][1],
        "per_step_busy_share": dev_ms / runs[1][1],
        "megastep_busy_share": dev_ms / runs[MEGASTEP_K][1],
        "readbacks_per_epoch": runs[MEGASTEP_K][2], "bitwise": True}
    del runs, per_step, mega, g

    # the narrow AlexNet with dropout: the chunk's keys from a device
    # tensor draw the masks the per-step loop draws on the host
    rng = np.random.RandomState(5)
    alex = [DataSet((rng.rand(16, 3, 67, 67) * 0.9 + 0.05).astype(
        np.float32), np.eye(10, dtype=np.float32)[rng.randint(0, 10, 16)])
        for _ in range(MEGASTEP_ALEX_STEPS)]
    a1 = MultiLayerNetwork(narrow_alexnet(), device="cuda").init()
    a4 = MultiLayerNetwork(narrow_alexnet(), device="cuda").init(
        params=a1.params)
    a1.fit(alex)
    a4.fit(alex, megastep=MEGASTEP_ALEX_K)
    torch.cuda.synchronize()
    if a4.iteration_count != MEGASTEP_ALEX_STEPS or not same_trees(
            torch, a1, a4):
        raise RuntimeError("[megastep] narrow AlexNet with dropout: the "
                           "chunks differ from the per-step loop")

    # [guard]'s poisoned run: the bad steps inside chunks
    gb = guard_batches()
    guarded = []
    for k in (1, MEGASTEP_K):
        net = MultiLayerNetwork(conf, device="cuda").init(params=init)
        net.set_divergence_guard(DivergenceGuard("skip", stats=guard_stats()))
        net.fit(gb, megastep=k)
        guarded.append(net)
    skipped = [n.divergence_guard.skipped_batches for n in guarded]
    if (skipped != [[GUARD_NAN_STEP, GUARD_SPIKE_STEP]] * 2
            or not same_trees(torch, *guarded) or not all(
                torch.equal(guarded[0]._stat_guard_state[k], v)
                for k, v in guarded[1]._stat_guard_state.items())):
        raise RuntimeError(f"[megastep] guarded: skipped {skipped}, or the "
                           "trees differ")
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    res = {"lenet": lenet_res, "narrow_alexnet_dropout": {
        "steps": MEGASTEP_ALEX_STEPS, "k": MEGASTEP_ALEX_K,
        "bitwise": True, "score": a4.score_value},
        "guard": {"k": MEGASTEP_K, "skipped_batches": skipped[1],
                  "bitwise": True},
        "launches_counted_at_capture": {k: v for k, v in launches.items()
                                        if v}}
    print(f"[megastep] {json.dumps(res)} card={card}")
    return launches


def events_ms(torch, fn, reps: int = 20):
    """Device time of one ``fn()`` call over ``reps`` back-to-back calls
    timed with CUDA events, and the host's time to enqueue one: for
    calls of a millisecond or so, no graph needed. The device time
    holds while the host enqueues a call faster than the card runs it
    (the second number says so)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    end.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def lstm_work(kind, T, b, n, variant):
    """(FLOPs, bytes) an LSTM kernel launch needs: the FMAs of h @ RW
    (and, backward, of dz @ RW^T) as 2 operations each, the gate
    arithmetic left out (under 2 % at n 200); each input read once and
    each output written once, in f32."""
    step = 2.0 * b * n * 4 * n
    if kind == "lstm_cell":
        words = (b * 4 * n + 2 * b * n + n * 4 * n + 2 * b * n
                 + (3 * n if variant == "peephole" else 0))
        return step, 4.0 * words
    if kind == "lstm_seq_fwd":
        outs = T * b * n * (2 if variant == "c_seq" else 1) + 2 * b * n
        return T * step, 4.0 * (T * b * 4 * n + n * 4 * n + 2 * b * n + outs)
    words = (T * b * 4 * n + 4 * T * b * n + n * 4 * n + 2 * b * n  # in
             + T * b * 4 * n + 2 * b * n)                          # out
    return 2.0 * T * step, 4.0 * words


def close_to_scale(torch, got, ref, rel: float) -> float:
    """Hold ``got`` to ``ref`` within ``rel`` of ref's largest entry;
    returns the largest absolute difference."""
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=0, atol=rel * max(scale, 1.0))
    return float((got - ref).abs().max())


def check_lstm_kernels(torch, model, T, b, n, gen):
    """The three LSTM kernels (both variants of the cell and of the
    sequence forward) against their plain versions on the card at (T, b,
    n), timed; returns one record each."""
    from deeplearning4j_tpu_torch.ops import (
        lstm_cell,
        lstm_cell_reference,
        lstm_seq_bwd,
        lstm_seq_bwd_reference,
        lstm_seq_fwd,
        lstm_seq_fwd_reference,
    )
    from deeplearning4j_tpu_torch.ops.lstm_cell import (
        lstm_cell_plan,
        lstm_seq_plan,
    )

    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    xproj = randn(T, b, 4 * n, scale=0.5)
    h0, c0 = randn(b, n, scale=0.1), randn(b, n, scale=0.1)
    rw = randn(n, 4 * n, scale=n ** -0.5)
    peeps = tuple(randn(n, scale=0.1) for _ in range(3))
    hseq, cseq, _, _ = lstm_seq_fwd_reference(xproj, h0, c0, rw)
    hprev = torch.cat([h0[None], hseq[:-1]]).contiguous()
    cprev = torch.cat([c0[None], cseq[:-1]]).contiguous()
    dhseq = randn(T, b, n)
    dhT, dcT = randn(b, n), randn(b, n)
    bwd_args = (xproj, hprev, cprev, cseq, rw, dhseq, dhT, dcT)
    cases = []
    for variant, p in (("plain", None), ("peephole", peeps)):
        cases.append(("lstm_cell", variant,
                      lambda p=p: lstm_cell(xproj[0], h0, c0, rw, p),
                      lambda p=p: lstm_cell_reference(xproj[0], h0, c0, rw,
                                                      p)))
    for variant, save in (("c_seq", True), ("no_c_seq", False)):
        cases.append(("lstm_seq_fwd", variant,
                      lambda s=save: lstm_seq_fwd(xproj, h0, c0, rw, s),
                      lambda s=save: lstm_seq_fwd_reference(xproj, h0, c0,
                                                            rw, s)))
    cases.append(("lstm_seq_bwd", "", lambda: lstm_seq_bwd(*bwd_args),
                  lambda: lstm_seq_bwd_reference(*bwd_args)))
    records = []
    for kind, variant, kernel, plain in cases:
        with torch.inference_mode():
            got, ref, again = kernel(), plain(), kernel()
            torch.cuda.synchronize()
            # f32 on both sides (TF32 off); sums of up to n O(1) products
            # in another order, carried through T steps: held within 1e-4
            # of each output's largest entry
            err = max(close_to_scale(torch, a, r, 1e-4)
                      for a, r in zip(got, ref) if r is not None)
            if not all(torch.equal(a, a2) for a, a2 in zip(got, again)
                       if a is not None):
                raise RuntimeError(f"{model} {kind}: two launches differ")
            if kind == "lstm_cell":
                ms, host_ms = graph_ms(torch, kernel), None
            else:
                ms, host_ms = events_ms(torch, kernel)
            plain_ms = graph_ms(torch, plain, reps=1)
        flops, nbytes = lstm_work(kind, T, b, n, variant)
        bound_ms, bound_by = bound(flops, nbytes)
        plan = (lstm_cell_plan(b, n) if kind == "lstm_cell" else
                lstm_seq_plan(b, n, kind == "lstm_seq_bwd", T))
        rec = {"kernel": kind, "kernel_route": plan["route"],
               "variant": variant, "shape_of": model,
               "T": T if kind != "lstm_cell" else 1, "b": b, "n": n,
               "max_abs_err": err, "kernel_ms": ms,
               "host_enqueue_ms": host_ms, "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": bound_ms,
               "bound_by": bound_by, "gflop": flops / 1e9,
               "mb": nbytes / 1e6}
        rec["plan"] = plan
        records.append(rec)
    return records


def lstm_layer_vs_cudnn(torch, model, T, b, n_in, n, gen):
    """Layer-level yardstick: the port's no-peephole GravesLSTM (the
    input projection plus the sequence kernels) against one
    ``torch.nn.LSTM`` (cuDNN, TF32 off) on the same weights, the gates
    permuted from i, f, o, g to cuDNN's i, f, g, o and ``b_hh`` zero.
    Forward times, and backward times of a retained graph (dx and every
    weight's gradient), all on the device clock: the profiler's sum of
    the device activities of 5 calls (``profiled_device_ms``; the port's
    cluster or cooperative launches and cuDNN's RNN calls alike), over
    5."""
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM

    dev = torch.device("cuda")
    layer = GravesLSTM(n_in=n_in, n_out=n, peephole=False)
    params = {k: v.to(dev) for k, v in layer.init_params(
        torch.Generator().manual_seed(0)).items()}
    x = torch.randn((b, n_in, T), device=dev, generator=gen)
    lstm = torch.nn.LSTM(n_in, n).to(dev)
    cols = torch.cat([torch.arange(0, 2 * n), torch.arange(3 * n, 4 * n),
                      torch.arange(2 * n, 3 * n)]).to(dev)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(params["W"][:, cols].t())
        lstm.weight_hh_l0.copy_(params["RW"][:, cols].t())
        lstm.bias_ih_l0.copy_(params["b"][cols])
        lstm.bias_hh_l0.zero_()
    x_tbi = x.permute(2, 0, 1).contiguous()
    with torch.inference_mode():
        ours = layer.apply(params, x, {})[0]
        lib = lstm(x_tbi)[0].permute(1, 2, 0)
        err = close_to_scale(torch, ours, lib, 1e-4)
        port_fwd = device_ms(torch, lambda: layer.apply(params, x, {}))
        cudnn_fwd = device_ms(torch, lambda: lstm(x_tbi))
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xg = x.clone().requires_grad_(True)
    y = layer.apply(leaves, xg, {}, train=True)[0]
    g = torch.randn(y.shape, device=dev, generator=gen)
    port_bwd = device_ms(torch, lambda: torch.autograd.grad(
        y, [xg, *leaves.values()], g, retain_graph=True))
    xl = x_tbi.clone().requires_grad_(True)
    out = lstm(xl)[0]
    gl = g.permute(2, 0, 1).contiguous()
    cudnn_bwd = device_ms(torch, lambda: torch.autograd.grad(
        out, [xl, *lstm.parameters()], gl, retain_graph=True))
    return {"shape_of": model, "T": T, "b": b, "n_in": n_in, "n": n,
            "clock": "device (torch.profiler kernel sum)",
            "max_abs_err_vs_cudnn": err, "port_fwd_ms": port_fwd,
            "cudnn_fwd_ms": cudnn_fwd, "port_bwd_ms": port_bwd,
            "cudnn_bwd_ms": cudnn_bwd}


def device_ms(torch, fn, reps: int = 5) -> float:
    """Device time of one ``fn()`` call: the profiler's sum of the device
    activities of ``reps`` calls (after two warm-up calls), over reps."""
    for _ in range(2):
        fn()

    def run():
        for _ in range(reps):
            fn()
    return profiled_device_ms(torch, run)[0] / reps


def charrnn_conf(peephole: bool):
    """BASELINE.json config #3 as the zoo builds it (peepholes), or the
    same widths with ``GravesLSTM(peephole=False)``."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.zoo import graves_lstm_char_rnn

    if peephole:
        return graves_lstm_char_rnn(vocab=CHAR_VOCAB, hidden=CHAR_HIDDEN,
                                    tbptt_length=CHAR_TBPTT)
    b = (NeuralNetConfiguration.Builder().seed(42).learning_rate(0.1)
         .updater("RMSPROP").list())
    n_in = CHAR_VOCAB
    for _ in range(2):
        b.layer(GravesLSTM(n_in=n_in, n_out=CHAR_HIDDEN, activation="tanh",
                           peephole=False))
        n_in = CHAR_HIDDEN
    return (b.layer(RnnOutputLayer(n_out=CHAR_VOCAB, loss="MCXENT"))
            .backprop_type("TruncatedBPTT")
            .t_bptt_forward_length(CHAR_TBPTT)
            .t_bptt_backward_length(CHAR_TBPTT).build())


def profiled_device_ms(torch, fn):
    """Device time of ``fn()`` under ``torch.profiler``: the sum of the
    traced device activities' own times (kernels and copies), and the
    five largest activities by name (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(evt, attr, None)
            if v is not None:
                by_name[evt.key] = by_name.get(evt.key, 0.0) + float(v) / 1e3
                break
    total = sum(by_name.values())
    if total <= 0.0:
        raise RuntimeError("the profiler traced no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return total, dict(top)


def run_charrnn(torch, card, peephole: bool, ids, alphabet):
    """The char-RNN on the card through its user entry points: ``fit``
    under truncated BPTT on SURVEY.md segments, ``output`` and the
    ``rnn_time_step`` sampling loop; returns the launch counts of that
    run (the main path)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch

    # the module (the package's ``lstm_cell`` name is its function)
    lstm_ops = importlib.import_module("deeplearning4j_tpu_torch.ops.lstm_cell")
    tag = "charrnn" if peephole else "charrnn-seq"
    conf = charrnn_conf(peephole)
    net = MultiLayerNetwork(conf, device="cuda").init()
    init = {ln: {pn: t.clone() for pn, t in lp.items()}
            for ln, lp in net.params.items()}
    twin = cpu_twin(torch, net)
    chunks = CHAR_SEGMENT // CHAR_TBPTT
    batches = char_batches(ids, CHAR_BATCH, CHAR_SEGMENT, CHAR_MINIBATCHES,
                           seed=1)
    probe = char_batches(ids, CHAR_BATCH, CHAR_SEGMENT, 1, seed=99)[0]
    three = char_batches(ids, CHAR_BATCH, 3 * CHAR_TBPTT, 1, seed=2)[0]
    print(f"[{tag}] 2 x GravesLSTM({CHAR_HIDDEN}, peephole={peephole}), "
          f"vocab {CHAR_VOCAB}, RMSProp lr 0.1, batch {CHAR_BATCH}, "
          f"{CHAR_SEGMENT}-char segments of SURVEY.md, TBPTT "
          f"{CHAR_TBPTT} ({net.num_params()} params)")

    # the sequence forward's variant per launch (c_seq written or not)
    variants = []
    kernel_fwd = lstm_ops._kernel_seq_fwd

    def spy(xproj, h0, c0, rw, save_cseq):
        variants.append(bool(save_cseq))
        return kernel_fwd(xproj, h0, c0, rw, save_cseq)

    lstm_ops._kernel_seq_fwd = spy
    try:
        # three chunks on the card and on the CPU twin (the plain path).
        # RMSProp moves a weight by ~4.5 lr on its first step whatever
        # its gradient above ~5e-4, and by up to 1e4 lr g below, so a
        # small gradient summed over 50 steps in another order moves a
        # few weights differently (0.04 % of RW's entries by up to 0.02
        # lr on an H100): scores within rtol 1e-3, every weight within
        # lr, and at most 1 % of any parameter's entries beyond 1e-4 +
        # 1e-3 |w|
        net.fit(three)
        twin.fit(three)
        np.testing.assert_allclose(net.score_value, twin.score_value,
                                   rtol=1e-3)
        max_diff, max_off = 0.0, 0.0
        for ln, lp in twin.params.items():
            for pn, ref in lp.items():
                d = (net.params[ln][pn].cpu() - ref).abs()
                off = float((d > 1e-4 + 1e-3 * ref.abs()).float().mean())
                max_diff = max(max_diff, float(d.max()))
                max_off = max(max_off, off)
                if float(d.max()) > 0.1 or off > 0.01:
                    raise RuntimeError(
                        f"{tag}: card and CPU twin differ at {ln}/{pn}: "
                        f"max {float(d.max())}, {off:.2%} off")
        # the same three chunks again from the same start: the same bits
        again = MultiLayerNetwork(conf, device="cuda").init(params=init)
        again.fit(three)
        torch.cuda.synchronize()
        for ln, lp in net.params.items():
            for pn, t in lp.items():
                if not (torch.equal(t, again.params[ln][pn]) and all(
                        torch.equal(a, b) for a, b in zip(
                            net.updater_state[ln][pn],
                            again.updater_state[ln][pn]))):
                    raise RuntimeError(f"{tag}: two card runs differ at "
                                       f"{ln}/{pn}")
        # one minibatch's launches, exactly
        dispatch.reset_launch_counts()
        again.fit(batches[0])
        torch.cuda.synchronize()
        per_batch = dispatch.launch_counts()
        steps = 2 * CHAR_TBPTT * chunks        # 2 layers x 200 steps
        expected = {k: 0 for k in per_batch}
        if peephole:
            expected["lstm_cell"] = steps
        else:
            expected["lstm_seq_fwd"] = expected["lstm_seq_bwd"] = 2 * chunks
        if per_batch != expected:
            raise RuntimeError(f"{tag}: one minibatch launched {per_batch}, "
                               f"expected {expected}")
        if not peephole and variants[-2 * chunks:] != [True] * (2 * chunks):
            raise RuntimeError(f"{tag}: training ran the c_seq-free forward")
        mask = np.ones((CHAR_BATCH, CHAR_SEGMENT), np.float32)
        mask[: CHAR_BATCH // 4, 3 * CHAR_SEGMENT // 4:] = 0.0
        masked = DataSet(probe.features, probe.labels, features_mask=mask,
                         labels_mask=mask)

        # the main path: a fresh network fits the minibatches, then
        # answers output and samples through rnn_time_step
        model = MultiLayerNetwork(conf, device="cuda").init(params=init)
        before = model.score(probe)
        torch.cuda.synchronize()
        del variants[:]
        dispatch.reset_launch_counts()
        scores = []
        t0 = time.perf_counter()
        for ds in batches:
            model.fit(ds)
            scores.append(model.score_value)  # waits for the card
        wall = time.perf_counter() - t0
        fit_counts = dispatch.launch_counts()
        if not peephole:
            # a features mask routes the same layers to the per-step cell
            model.fit(masked)
        seg = probe.features[:4]
        out = model.output(seg)
        n_out_fwd = len(variants)
        sample, stepped = sample_chars(torch, model, CHAR_SAMPLE, seed=7)
        torch.cuda.synchronize()
        launches = dispatch.launch_counts()
    finally:
        lstm_ops._kernel_seq_fwd = kernel_fwd
    n_chunks = CHAR_MINIBATCHES * chunks
    want = {k: 0 for k in launches}
    if peephole:
        want["lstm_cell"] = (CHAR_MINIBATCHES * steps + 2 * CHAR_SEGMENT
                             + 2 * CHAR_SAMPLE)
    else:
        want["lstm_cell"] = steps
        want["lstm_seq_fwd"] = 2 * n_chunks + 2 + 2 * CHAR_SAMPLE
        want["lstm_seq_bwd"] = 2 * n_chunks
        # fit: the c_seq variant; output and sampling: the c_seq-free one
        if variants != ([True] * 2 * n_chunks
                        + [False] * (2 + 2 * CHAR_SAMPLE)):
            raise RuntimeError(f"{tag}: sequence forward variants "
                               f"{variants[:3]}... of {len(variants)}")
    if launches != want:
        raise RuntimeError(f"{tag}: the main path launched {launches}, "
                           f"expected {want}")
    # at the zoo's lr 0.1, RMSProp's first steps move every weight by
    # ~0.45: the score leaps from ln(77) before it falls, so the run is
    # held to its first minibatch's score
    after = model.score(probe)
    if not all(np.isfinite(scores)) or not scores[-1] < scores[0]:
        raise RuntimeError(f"{tag}: the score did not fall: {scores}")
    # output on a segment against the CPU twin (plain path, same weights)
    ref = cpu_twin(torch, model).output(seg)
    out_err = close_to_scale(torch, out.cpu(), ref, 1e-4)
    if out.shape != (4, CHAR_VOCAB, CHAR_SEGMENT) or not bool(
            torch.isfinite(out).all()):
        raise RuntimeError(f"{tag}: bad output {tuple(out.shape)}")
    # the sampled sequence fed whole through output: the same
    # probabilities the streaming calls gave, step by step
    eye = np.eye(CHAR_VOCAB, dtype=np.float32)
    whole = model.output(eye[sample[:-1]].T[None])[0]
    sample_err = close_to_scale(torch, stepped, whole, 1e-4)
    # device time of the fit, from the profiler, over two minibatches
    prof_batches = char_batches(ids, CHAR_BATCH, CHAR_SEGMENT, 2, seed=3)
    device_ms, top = profiled_device_ms(torch,
                                        lambda: model.fit(prof_batches))
    device_ms /= 2 * chunks
    ms_per_chunk = wall / n_chunks * 1e3
    res = {"minibatches": CHAR_MINIBATCHES, "chunks": n_chunks,
           "chars_per_s": CHAR_MINIBATCHES * CHAR_BATCH * CHAR_SEGMENT / wall,
           "host_ms_per_chunk": ms_per_chunk,
           "device_ms_per_chunk": device_ms,
           "device_busy_share": device_ms / ms_per_chunk,
           "top_device_ms_per_chunk": {k[:60]: v / (2 * chunks)
                                       for k, v in top.items()},
           "minibatch_scores": scores,
           "probe_score_before": before, "probe_score_after": after,
           "launches_per_minibatch": {k: v for k, v in per_batch.items()
                                      if v},
           "fit_launches": {k: v for k, v in fit_counts.items() if v},
           "main_path_launches": {k: v for k, v in launches.items() if v},
           "output_c_seq_free_launches": n_out_fwd - 2 * n_chunks
           if not peephole else 0,
           "twin_scores": {"card": net.score_value, "cpu": twin.score_value},
           "twin_max_abs_diff": max_diff, "twin_max_share_off": max_off,
           "output_max_abs_err_vs_plain": out_err,
           "sample_max_abs_err_vs_output": sample_err,
           "sample_head": "".join(alphabet[i] if i < len(alphabet) else "?"
                                  for i in sample[:60])}
    print(f"[{tag}] {json.dumps(res)} card={card}")
    return launches


def sample_chars(torch, model, length: int, seed: int):
    """``length`` characters drawn one at a time through
    ``rnn_time_step`` (batch 1) from a seeded numpy generator after a
    seeded start character; returns the ``length + 1`` ids and the
    ``[vocab, length]`` probabilities the streaming calls gave."""
    rng = np.random.RandomState(seed)
    eye = np.eye(CHAR_VOCAB, dtype=np.float32)
    model.rnn_clear_previous_state()
    ids = [int(rng.randint(0, CHAR_VOCAB - 1))]
    probs = []
    for _ in range(length):
        p = model.rnn_time_step(eye[ids[-1]][None])[0]
        probs.append(p)
        q = p.double().cpu().numpy()
        ids.append(int(rng.choice(CHAR_VOCAB, p=q / q.sum())))
    model.rnn_clear_previous_state()
    return np.array(ids), torch.stack(probs, dim=1)


def attention_work(bh, t, d, causal=True):
    """(FLOPs, bytes per element) of one attention forward: the two
    products over the unmasked (query, key) pairs, 2 operations a
    multiply-add; q, k, v read once and o written once (4 * bh * t * d
    elements)."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return 4.0 * d * pairs * bh, 4.0 * bh * t * d


def check_flash_kernels(torch, F, gen):
    """Both flash-attention entries against their plain version on the
    card, in f32 and bf16 (and f16, which [f16-loss-scale] trains in, at
    the training shape): at the transformer's training shape (b 16,
    h 12, t 512, d 64), and the streamed entry also at the long-context
    shape (b 1, h 12, t 16384). Two launches must give the same bits.
    Timed beside the plain version and ``scaled_dot_product_attention``
    (the library yardstick, never called by the port)."""
    fa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")
    dev = torch.device("cuda")
    hd = TX["d_model"] // TX["n_heads"]
    cases = (("transformer", (TX_BATCH, TX["n_heads"], TX_T, hd),
              ("flash_attention", "flash_attention_streamed")),
             ("long", (1, TX["n_heads"], TX_LONG_T, hd),
              ("flash_attention_streamed",)))
    records = []
    for tag, shape, entries in cases:
        b, h, t, d = shape
        base = [torch.randn(shape, device=dev, generator=gen)
                for _ in range(3)]
        dtypes = (torch.float32, torch.bfloat16) + (
            (torch.float16,) if tag == "transformer" else ())
        for dtype in dtypes:
            q, k, v = (a.to(dtype) for a in base)
            for entry in entries:
                streamed = entry == "flash_attention_streamed"

                def kernel():
                    return fa._kernel_forward(q, k, v, True, streamed)

                def plain():
                    return fa.flash_attention_reference(q, k, v, True,
                                                        streamed=streamed)

                def library():
                    return F.scaled_dot_product_attention(q, k, v,
                                                          is_causal=True)
                with torch.inference_mode():
                    got, again, ref = kernel(), kernel(), plain()
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise RuntimeError(f"{entry} {tag} {dtype}: two "
                                           "launches differ")
                    err = float((got.float() - ref.float()).abs().max())
                    if dtype == torch.float32:
                        # f32 both sides, sums over up to 16384 keys in
                        # another order: to f32 rounding of O(1) outputs
                        torch.testing.assert_close(got, ref, rtol=1e-4,
                                                   atol=2e-5)
                    else:
                        # the same half inputs and f32 arithmetic on both
                        # sides; each output rounds once to its type (the
                        # card tests' half tolerance)
                        torch.testing.assert_close(got.float(), ref.float(),
                                                   rtol=1e-2, atol=1e-2)
                    lib_err = float((library().float()
                                     - ref.float()).abs().max())
                    if t <= TX_T:
                        ms, plain_ms = graph_ms(torch, kernel), graph_ms(
                            torch, plain)
                        library_ms = graph_ms(torch, library)
                    else:
                        ms = events_ms(torch, kernel, reps=5)[0]
                        plain_ms = events_ms(torch, plain, reps=2)[0]
                        library_ms = events_ms(torch, library, reps=5)[0]
                flops, elems = attention_work(b * h, t, d)
                nbytes = elems * q.element_size()
                peak = (PEAK_FP32_FLOPS if dtype == torch.float32
                        else PEAK_BF16_FLOPS)
                bound_ms, bound_by = bound(flops, nbytes, peak)
                records.append({
                    "kernel": entry, "kernel_route": "single",
                    "shape_of": tag, "b": b, "h": h, "t": t,
                    "d": d, "dtype": str(dtype).replace("torch.", ""),
                    "max_abs_err": err, "library_max_abs_err": lib_err,
                    "kernel_ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "gflop": flops / 1e9,
                    "mb": nbytes / 1e6})
    return records


def check_transformer_matmuls(torch, gen):
    """The dense kernel at the transformer's two shapes: the input
    projection (m 8192, k 256, n 768, identity) and the residual variant
    at the FFN's second product (m 8192, k 3072, n 768, the block input
    as r), against the plain version, f32, bf16 and f16 (the dtypes the
    transformer phases train in), timed in f32 beside ``torch.addmm``
    (+ the residual add)."""
    from deeplearning4j_tpu_torch.ops import (
        matmul_block,
        matmul_block_reference,
    )
    from deeplearning4j_tpu_torch.ops.matmul_block import matmul_route

    dev = torch.device("cuda")
    m, d = TX_BATCH * TX_T, TX["d_model"]
    records = []
    for name, k, with_res in (("input", TX["vocab"], False),
                              ("ffn2", 4 * d, True)):
        x = torch.randn(m, k, device=dev, generator=gen)
        w = torch.randn(k, d, device=dev, generator=gen) / k ** 0.5
        b = 0.1 * torch.randn(d, device=dev, generator=gen)
        r = torch.randn(m, d, device=dev, generator=gen) if with_res else None

        def kernel():
            return matmul_block(x, w, b, r)

        def plain():
            return matmul_block_reference(x, w, b, r)

        def library():
            y = torch.addmm(b, x, w)
            return y.add_(r) if with_res else y
        with torch.inference_mode():
            got, again, ref = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise RuntimeError(f"transformer.{name}: two launches differ")
            err = float((got - ref).abs().max())
            # f32 both sides (TF32 off), sums of up to 3072 O(1) products
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
            half_err = {}
            for half in (torch.bfloat16, torch.float16):
                rh = None if r is None else r.to(half)
                gh = matmul_block(x.to(half), w.to(half), b, rh)
                ph = matmul_block_reference(x.to(half), w.to(half), b, rh)
                if gh.dtype != half:
                    raise RuntimeError(f"transformer.{name}: wrote "
                                       f"{gh.dtype} for {half}")
                # f32 sums on both sides, each output rounded once to
                # its type (the card tests' half tolerance)
                torch.testing.assert_close(gh.float(), ph.float(),
                                           rtol=2e-2, atol=2e-2)
                half_err[str(half).replace("torch.", "")] = float(
                    (gh.float() - ph.float()).abs().max())
            ms, plain_ms = graph_ms(torch, kernel), graph_ms(torch, plain)
            library_ms = graph_ms(torch, library)
        flops = 2.0 * m * k * d
        nbytes = 4.0 * (x.numel() + w.numel() + b.numel() + m * d
                        + (m * d if with_res else 0))
        bound_ms, bound_by = bound(flops, nbytes)
        records.append({
            "kernel": "matmul_block_residual" if with_res else "matmul_block",
            "kernel_route": matmul_route(m, d),
            "shape_of": f"transformer.{name}", "m": m, "k": k, "n": d,
            "max_abs_err": err, "half_max_abs_err": half_err,
            "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "gflop": flops / 1e9, "mb": nbytes / 1e6})
    return records


# The route each main-path shape of the routed kernels must take
# (ops.conv_block.conv_block_route, conv_bwd_data_route and
# conv_bwd_w_route, ops.matmul_block.matmul_route, ops.lstm_cell
# lstm_cell_route and lstm_seq_route),
# by the prefix of the record's shape_of.
INTENDED_ROUTES = {
    # ops.conv_block.conv_block_route: the wide implicit GEMM for
    # AlexNet's five convs at batch 64, LeNet's two at the training
    # batch and its first at the serving bucket, VGG-16's convs down to
    # 4 x 4 at batch 128 and all of ResNet-50's; the direct tile (split
    # k) for LeNet's second at the bucket and VGG-16's 2 x 2 convs
    "conv_block": (("alexnet.", "wide"), ("alexnet-train.", "wide"),
                   ("lenet256.", "wide"),
                   ("lenet.conv1", "wide"), ("lenet.conv2", "direct"),
                   ("vgg16.conv10", "direct"), ("vgg16.", "wide"),
                   ("resnet50.", "wide")),
    # VGG-16: the resident route at 16 x 16 and 8 x 8 (conv2-conv6), the
    # implicit GEMM at 32 x 32 and below 8 x 8; dW on the implicit GEMM
    # ResNet-50 (batch 128): the resident route at 14 x 14, c 1024 (16-
    # channel groups), at the 3 x 3 stride-2 conv onto 7 x 7 (4-channel
    # groups: the GEMM multiplies the taps no output reaches) and at 7 x
    # 7, c 2048 (32-channel groups); the implicit GEMM elsewhere, and for
    # every dW
    # AlexNet: 4-channel resident groups at conv5 (13 x 13, o 256), the
    # implicit GEMM at conv2-conv4; ResNet-50's 3 x 3 at 7 x 7 takes the
    # 4-channel groups too
    "conv_bwd_data": (("lenet256.", "resident"), ("alexnet.conv5",
                                                  "resident"),
                      ("alexnet-train.conv5", "resident"),
                      ("alexnet.", "gemm"), ("alexnet-train.", "gemm"),
                      ("vgg16.conv1", "gemm"), ("vgg16.conv7", "gemm"),
                      ("vgg16.conv8", "gemm"), ("vgg16.", "resident"),
                      ("resnet50.s2b1_c1", "resident"),
                      ("resnet50.s3b0_c2", "resident"),
                      ("resnet50.s3b1_c1", "resident"),
                      ("resnet50.s3b1_c2", "resident"),
                      ("resnet50.", "gemm")),
    "conv_bwd_w": (("lenet256.", "image_resident"), ("alexnet.", "gemm"),
                   ("alexnet-train.", "gemm"),
                   ("vgg16.", "gemm"), ("resnet50.", "gemm")),
    "matmul_block": (("transformer.", "wide"), ("lenet", "tiled"),
                     ("alexnet.", "tiled"), ("alexnet-train.", "tiled"),
                     ("vgg16.", "tiled"),
                     ("embedding-mlp.", "tiled")),
    "matmul_block_residual": (("transformer.", "wide"),),
    # ops.lstm_cell.lstm_seq_route: the char-RNN's chunk and sampling
    # launch on a cluster, bench.py's saturated shape on the grid
    "lstm_seq_fwd": (("charrnn", "cluster"), ("saturated", "grid")),
    # ops.lstm_cell.lstm_cell_route: the char-RNN's step and sampling
    # launch on the latency route, the saturated shape on the slices
    "lstm_cell": (("charrnn", "latency"), ("saturated", "slice")),
    "lstm_seq_bwd": (("charrnn", "cluster"), ("saturated", "grid")),
}


def check_routes(records):
    """Fail when a main-path shape of a routed kernel took another route
    than the one it was designed for: the first entry whose prefix the
    record's shape_of starts with decides."""
    for r in records:
        for prefix, want in INTENDED_ROUTES.get(r["kernel"], ()):
            if not r["shape_of"].startswith(prefix):
                continue
            if r["kernel_route"] != want:
                raise RuntimeError(
                    f"{r['shape_of']} {r['kernel']}: took the "
                    f"{r['kernel_route']} route, expected {want}")
            break


def tx_conf(n_layers=None):
    """The zoo's transformer LM at bench.py:866's widths (depth cut to
    ``n_layers`` where given)."""
    from deeplearning4j_tpu_torch.zoo import transformer_lm

    kw = dict(TX)
    if n_layers:
        kw["n_layers"] = n_layers
    return transformer_lm(**kw)


def tx_expected(**counts):
    from deeplearning4j_tpu_torch.ops import dispatch

    want = {k: 0 for k in dispatch.KERNELS}
    want.update(counts)
    return want


def run_transformer(torch, card, ids):
    """[transformer] full width (d 768, 12 layers, 12 heads, t 512,
    batch 16) fits 20 minibatches of SURVEY.md's bytes through
    ``MultiLayerNetwork.fit`` (Adam lr 3e-4, MCXENT); returns the trained
    network and the launch counts of the run (a main path)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch

    net = MultiLayerNetwork(tx_conf(), device="cuda").init()
    layers = TX["n_layers"]
    batches = char_batches(ids, TX_BATCH, TX_T, TX_STEPS, seed=5,
                           vocab=TX["vocab"])
    probe = batches[0]
    print(f"[transformer] transformer_lm({TX}) ({net.num_params()} params), "
          f"Adam, MCXENT, batch {TX_BATCH} x t {TX_T} of SURVEY.md's bytes, "
          f"f32")
    first = net.score(probe)
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    scores = []
    t0 = time.perf_counter()
    for ds in batches:
        net.fit(ds)
        scores.append(net.score_value)  # waits for the card
    wall = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    want = tx_expected(flash_attention=layers * TX_STEPS,
                       matmul_block=TX_STEPS,
                       matmul_block_residual=layers * TX_STEPS)
    if launches != want:
        raise RuntimeError(f"[transformer] {TX_STEPS} steps launched "
                           f"{launches}, expected {want}")
    # the step's score is the training forward on the weights before it:
    # the inference score of the same batch, to f32 rounding. At this
    # configuration's lr (3e-4, no warm-up) the score rises for the
    # first steps in the JAX package too (the same trajectory to 5
    # digits on the CPU), so the run is held to the CPU twin
    # ([transformer-twin]) rather than to a falling score
    if abs(scores[0] - first) > 1e-5 * abs(first):
        raise RuntimeError(f"first step scored {scores[0]}, the batch "
                           f"scores {first}")
    if not all(np.isfinite(scores)):
        raise RuntimeError(f"[transformer] a score is not finite: {scores}")
    device_ms, top = profiled_device_ms(torch, lambda: net.fit(batches[:2]))
    device_ms /= 2
    ms_per_step = wall / TX_STEPS * 1e3
    res = {"steps": TX_STEPS, "batch": TX_BATCH, "t": TX_T,
           "tokens_per_s": TX_STEPS * TX_BATCH * TX_T / wall,
           "ms_per_step": ms_per_step, "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / ms_per_step,
           "top_device_ms_per_step": {k[:60]: v / 2 for k, v in top.items()},
           "first_score": first, "scores": scores,
           "launches_per_step": {k: v // TX_STEPS for k, v in launches.items()
                                 if v},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[transformer] {json.dumps(res)} card={card}")
    return net, launches


def run_transformer_twin(torch, card, ids):
    """[transformer-twin] the full model (every width and all 12 layers)
    at batch 4, t 512: two Adam steps on the card and on the CPU twin
    (the plain path), scores and every weight held."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch

    layers = TX["n_layers"]
    net = MultiLayerNetwork(tx_conf(), device="cuda").init()
    twin = cpu_twin(torch, net)
    lr = TX["learning_rate"]
    batches = char_batches(ids, 4, TX_T, 2, seed=6, vocab=TX["vocab"])
    dispatch.reset_launch_counts()
    card_scores, cpu_scores = [], []
    for ds in batches:
        net.fit(ds)
        twin.fit(ds)
        card_scores.append(net.score_value)
        cpu_scores.append(twin.score_value)
    launches = dispatch.launch_counts()
    want = tx_expected(flash_attention=2 * layers, matmul_block=2,
                       matmul_block_residual=2 * layers)
    if launches != want:
        raise RuntimeError(f"[transformer-twin] launched {launches}")
    # Adam moves a weight by about lr a step whatever its gradient's
    # size, so a gradient at the f32 noise floor can move differently:
    # scores within rtol 1e-3, every weight within 3 lr, and at most 1 %
    # of any parameter's entries beyond 1e-4 + 1e-3 |w|
    np.testing.assert_allclose(card_scores, cpu_scores, rtol=1e-3)
    max_diff, max_off = 0.0, 0.0
    for ln, lp in twin.params.items():
        for pn, ref in lp.items():
            dlt = (net.params[ln][pn].cpu() - ref).abs()
            off = float((dlt > 1e-4 + 1e-3 * ref.abs()).float().mean())
            max_diff = max(max_diff, float(dlt.max()))
            max_off = max(max_off, off)
            if float(dlt.max()) > 3 * lr or off > 0.01:
                raise RuntimeError(f"[transformer-twin] card and CPU differ "
                                   f"at {ln}/{pn}: max {float(dlt.max())}, "
                                   f"{off:.2%} off")
    res = {"layers": layers, "batch": 4, "t": TX_T,
           "scores": {"card": card_scores, "cpu": cpu_scores},
           "max_abs_diff": max_diff, "max_share_off": max_off}
    print(f"[transformer-twin] {json.dumps(res)} card={card}")


def sample_transformer(torch, card, model, ids, seed):
    """[transformer-sample] ``rnn_time_step`` on a 256-byte prompt of
    SURVEY.md, then 64 bytes drawn one at a time (seeded numpy) through
    the KV cache; the probabilities must match ``output`` on the same
    320 bytes, and overflowing the cache must raise. Returns the launch
    counts of the streaming calls (a main path)."""
    from deeplearning4j_tpu_torch.ops import dispatch

    vocab, layers = TX["vocab"], TX["n_layers"]
    rng = np.random.RandomState(seed)
    eye = np.eye(vocab, dtype=np.float32)
    start = rng.randint(0, len(ids) - TX_PROMPT)
    fed = [int(i) for i in ids[start:start + TX_PROMPT]]

    def draw(p):
        q = p.double().cpu().numpy()
        return int(rng.choice(vocab, p=q / q.sum()))

    model.rnn_clear_previous_state()
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.rnn_time_step(np.ascontiguousarray(eye[fed].T[None]))[0]
    prompt_s = time.perf_counter() - t0
    probs = [out]
    nxt = draw(out[:, -1])
    t0 = time.perf_counter()
    for _ in range(TX_SAMPLE):
        fed.append(nxt)
        p = model.rnn_time_step(eye[nxt][None])[0]
        probs.append(p[:, None])
        nxt = draw(p)
    step_ms = (time.perf_counter() - t0) / TX_SAMPLE * 1e3
    launches = dispatch.launch_counts()
    calls = 1 + TX_SAMPLE
    want = tx_expected(matmul_block=calls,
                       matmul_block_residual=layers * calls)
    if launches != want:
        raise RuntimeError(f"[transformer-sample] launched {launches}, "
                           f"expected {want}")
    # the cache holds kv_cache timesteps: one chunk more must raise
    cap = model.conf.layers[2].kv_cache
    over = np.zeros((1, vocab, cap - len(fed) + 1), np.float32)
    try:
        model.rnn_time_step(over)
    except ValueError as e:
        if "overflow" not in str(e):
            raise
    else:
        raise RuntimeError("overflowing the KV cache did not raise")
    model.rnn_clear_previous_state()
    stepped = torch.cat(probs, dim=1)
    whole = model.output(np.ascontiguousarray(eye[fed].T[None]))[0]
    # the cache's materialized attention vs the flash kernel over 12
    # layers, f32; after 20 steps at lr 3e-4 the logits span tens of
    # units, so their f32 rounding moves a probability by up to ~1e-4 of
    # the largest: held within 1e-3 of it
    err = close_to_scale(torch, stepped, whole, 1e-3)
    res = {"prompt": TX_PROMPT, "sampled": TX_SAMPLE,
           "prompt_ms": prompt_s * 1e3, "ms_per_sampled_byte": step_ms,
           "launches": {k: v for k, v in launches.items() if v},
           "max_abs_err_vs_output": err,
           "sample": bytes(fed[TX_PROMPT:]).decode("utf-8", "replace")}
    print(f"[transformer-sample] {json.dumps(res)} card={card}")
    return launches


def run_transformer_long(torch, card, model, ids, seed):
    """[transformer-long] ``output`` on 16,384 bytes of SURVEY.md at
    full depth: t * d = 1,048,576 > 524,288, so every layer launches the
    streamed entry; its first 512 positions must match ``output`` on
    those 512 bytes (the resident entry), by causality the same
    function. Returns the launch counts of both calls (a main path)."""
    from deeplearning4j_tpu_torch.ops import dispatch

    vocab, layers = TX["vocab"], TX["n_layers"]
    rng = np.random.RandomState(seed)
    start = rng.randint(0, len(ids) - TX_LONG_T)
    x = np.ascontiguousarray(
        np.eye(vocab, dtype=np.float32)[ids[start:start + TX_LONG_T]].T[None])
    xt = torch.from_numpy(x).cuda()
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.output(xt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    long_counts = dispatch.launch_counts()
    want = tx_expected(flash_attention_streamed=layers,
                       matmul_block=1, matmul_block_residual=layers)
    if long_counts != want:
        raise RuntimeError(f"[transformer-long] launched {long_counts}, "
                           f"expected {want}")
    head = model.output(xt[:, :, :TX_T])
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    if launches["flash_attention"] != layers:
        raise RuntimeError(f"[transformer-long] the 512-byte output "
                           f"launched {launches}")
    if out.shape != (1, vocab, TX_LONG_T) or not bool(
            torch.isfinite(out).all()):
        raise RuntimeError(f"bad long output {tuple(out.shape)}")
    # same inputs up to position 512; the dense products of 16,384 and
    # 512 rows sum in other orders (split-K at 512 rows): to f32 rounding
    # of large logits, as in [transformer-sample]
    err = close_to_scale(torch, out[:, :, :TX_T], head, 1e-3)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.output(xt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    res = {"t": TX_LONG_T, "layers": layers, "first_call_ms": wall * 1e3,
           "ms_per_output": float(np.median(times)) * 1e3,
           "tokens_per_s": TX_LONG_T / float(np.median(times)),
           "launches": {k: v for k, v in launches.items() if v},
           "head_max_abs_err_vs_t512": err}
    print(f"[transformer-long] {json.dumps(res)} card={card}")
    return launches


# -- the NLP / embeddings slice ------------------------------------------


def zipf_sentences(n_sentences, sent_len, vocab, seed):
    """bench.py:699's corpus: ``n_sentences`` of ``sent_len`` words drawn
    from a Zipf distribution over ``vocab`` words (``RandomState(seed)``)."""
    rng = np.random.RandomState(seed)
    zipf = 1.0 / np.arange(1, vocab + 1)
    probs = zipf / zipf.sum()
    words = [f"w{i}" for i in range(vocab)]
    return [[words[i] for i in rng.choice(vocab, size=sent_len, p=probs)]
            for _ in range(n_sentences)]


def w2v_corpus():
    """bench.py's Word2Vec corpus, vocabulary and id sequences."""
    from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor

    sentences = zipf_sentences(W2V_SENTENCES, W2V_SENT_LEN, W2V_VOCAB, 0)
    cache = VocabConstructor(min_word_frequency=1).build_vocab_from_tokens(
        sentences)
    ids = [np.asarray([cache.index_of(w) for w in s if w in cache],
                      np.int32) for s in sentences]
    return cache, ids


def make_w2v(cache, ids, device="cuda", epochs=1, **kw):
    """bench.py's trainer: D 128, W 5, K 5, B 16384, seed 1."""
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    return Word2Vec(cache, ids, layer_size=W2V_DIM, window=W2V_WINDOW,
                    negative=W2V_NEG, batch_size=W2V_BATCH, epochs=epochs,
                    seed=W2V_SEED, device=device, **kw)


def w2v_tables(torch, sv):
    lk = sv.lookup
    return [t.detach().cpu().clone() for t in (lk.syn0, lk.syn1, lk.syn1neg)
            if t is not None]


def hold_change(torch, tag, got, want, start, rel=TWIN_REL):
    """Hold what a run changed: each of ``got``'s tables minus its
    ``start`` against ``want``'s minus the same start, within ``rel`` of
    the largest entry of ``want``'s change (no floor), so a run that
    left a table as it was, or moved it by another amount, fails.
    Returns the largest difference of the tables and the tightest
    tolerance that held them."""
    err, atol = 0.0, float("inf")
    for g, w, s in zip(got, want, start):
        g, w, s = g.cpu(), w.cpu(), s.cpu()
        moved = w - s
        scale = float(moved.abs().max())
        if scale == 0.0:
            raise RuntimeError(f"[{tag}] the CPU twin left a table as it was")
        try:
            torch.testing.assert_close(g - s, moved, rtol=0, atol=rel * scale)
        except AssertionError as e:
            raise RuntimeError(f"[{tag}] card and CPU twin differ: {e}")
        err = max(err, float((g - w).abs().max()))
        atol = min(atol, rel * scale)
    return err, atol


def run_word2vec(torch, card, cache, ids):
    """[word2vec] bench.py:699's configuration exactly (200,000 words of
    a Zipf corpus over 2,000 words, D 128, W 5, K 5, B 16,384, seed 1)
    through ``Word2Vec.fit`` with on-device epoch generation: a warm fit,
    then words/s as the best of 3 windows of 20 epochs; the cold rate
    (a fresh trainer's corpus upload + one epoch, best of 3); the device
    time of 2 epochs (``torch.profiler``) and its share of a window's
    epoch; peak memory. Two fresh trainers from the seed must give the
    same tables bit for bit, and one epoch's draws taken on the card, fed
    to the CPU from the same tables, must change the tables as on the
    card (``hold_change``)."""
    from deeplearning4j_tpu_torch.nlp import word2vec as w2v

    total_words = sum(len(s) for s in ids)
    torch.cuda.reset_peak_memory_stats()
    sv = make_w2v(cache, ids)
    if not sv._use_device_gen():
        raise RuntimeError("[word2vec] device generation is off on the card")

    def sync(v):
        torch.cuda.synchronize()
        float(v.lookup.syn0[0, 0])

    sv.fit()  # warm-up: the corpus upload and the first launches
    sync(sv)
    cold = []
    for _ in range(3):
        sv2 = make_w2v(cache, ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sv2.fit()
        sync(sv2)
        cold.append(time.perf_counter() - t0)
    upload = sv2._dev_upload_bytes
    del sv2
    sv.epochs = W2V_REPS
    sv.fit()
    sync(sv)
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        sv.fit()
        sync(sv)
        windows.append(time.perf_counter() - t0)
    sv.epochs = 2
    device_ms, top = profiled_device_ms(torch, sv.fit)
    best = min(windows)
    corpus = sv.device_corpus()
    n_batches = corpus.ids.shape[0] // W2V_BATCH
    rows = W2V_BATCH * (1 + 2 * W2V_WINDOW + W2V_NEG)
    # the step's own traffic: each gathered row read, its gradient
    # written and read back, each updated row read and written
    reckoned = n_batches * 4 * rows * W2V_DIM * 4
    dev_epoch_ms = device_ms / 2
    for t in w2v_tables(torch, sv):
        if not torch.isfinite(t).all():
            raise RuntimeError("[word2vec] a table is not finite")
    near = sv.words_nearest("w3", 10)
    if len(near) != 10 or "w3" in near:
        raise RuntimeError(f"[word2vec] words_nearest: {near}")

    # repeatability: two fresh trainers, two epochs each
    runs = []
    for _ in range(2):
        r = make_w2v(cache, ids, epochs=2)
        r.fit()
        runs.append(w2v_tables(torch, r))
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise RuntimeError("[word2vec] two fits from the same seed differ")

    # the CPU twin: one epoch's draws on the card, from the same tables
    t_twin = time.perf_counter()
    start = w2v_tables(torch, sv)
    gen = torch.Generator(device="cuda").manual_seed(W2V_SEED + 100)
    draws = w2v.epoch_draws(gen, corpus)
    alphas = torch.from_numpy(w2v.alpha_schedule(
        sv.learning_rate, sv.min_learning_rate, n_batches * W2V_BATCH, 0, 1,
        n_batches, W2V_BATCH))[0]
    w2v.sg_device_epoch(sv.lookup.syn0, sv.lookup.syn1neg, corpus, draws,
                        alphas.cuda(), negative=W2V_NEG, batch=W2V_BATCH)
    twin = make_w2v(cache, ids, device="cpu")
    twin.lookup.load_numpy(start[0], None, start[1])
    cpu_corpus = twin.device_corpus()
    w2v.sg_device_epoch(twin.lookup.syn0, twin.lookup.syn1neg, cpu_corpus,
                        tuple(d.cpu() for d in draws), alphas,
                        negative=W2V_NEG, batch=W2V_BATCH)
    twin_err, twin_atol = hold_change(torch, "word2vec",
                                      w2v_tables(torch, sv),
                                      w2v_tables(torch, twin), start)
    res = {"words": total_words, "vocab": len(cache), "dim": W2V_DIM,
           "window": W2V_WINDOW, "negative": W2V_NEG, "batch": W2V_BATCH,
           "batches_per_epoch": n_batches, "epochs_per_window": W2V_REPS,
           "words_per_s": W2V_REPS * total_words / best,
           "window_s": windows,
           "cold_words_per_s": total_words / min(cold), "cold_s": cold,
           "cold_upload_bytes": upload,
           "device_ms_per_epoch": dev_epoch_ms,
           "host_ms_per_epoch": best / W2V_REPS * 1e3,
           "device_busy_share": dev_epoch_ms / (best / W2V_REPS * 1e3),
           "top_device_ms_per_epoch": {k[:60]: v / 2
                                       for k, v in top.items()},
           "reckoned_bytes_per_epoch": reckoned,
           "reckoned_hbm_share": reckoned / PEAK_HBM_BYTES * 1e3
           / dev_epoch_ms,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "repeat_bitwise": True, "twin_max_abs_diff": twin_err,
           "twin_tolerance": TWIN_TOLERANCE, "twin_tightest_atol": twin_atol,
           "twin_s": time.perf_counter() - t_twin, "nearest_w3": near}
    print(f"[word2vec] {json.dumps(res)} card={card}")
    return sv


def run_word2vec_host(torch, card, cache, ids):
    """[word2vec-host] the same corpus with ``device_epoch_gen=False``:
    one epoch of the chunked host-pair route (numpy pairs, negatives and
    alphas, prepared chunks on the card), timed. The CPU twin is cut to
    the corpus's first ``W2V_TWIN_SENTENCES`` sentences: the same epoch
    on the card and on the CPU, on the same numpy draws, changes the
    tables alike (``hold_change``). Returns the full-corpus trainer."""
    sv = make_w2v(cache, ids)
    sv.device_epoch_gen = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sv.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    part = ids[:W2V_TWIN_SENTENCES]
    small = make_w2v(cache, part)
    small.device_epoch_gen = False
    small.fit()
    twin = make_w2v(cache, part, device="cpu")
    start = w2v_tables(torch, twin)
    twin.fit()
    err, atol = hold_change(torch, "word2vec-host",
                            w2v_tables(torch, small),
                            w2v_tables(torch, twin), start)
    res = {"words": sum(len(s) for s in ids), "epochs": 1,
           "words_per_s": sum(len(s) for s in ids) / wall,
           "wall_s": wall, "twin_sentences": W2V_TWIN_SENTENCES,
           "twin_max_abs_diff": err, "twin_tolerance": TWIN_TOLERANCE,
           "twin_tightest_atol": atol}
    print(f"[word2vec-host] {json.dumps(res)} card={card}")
    return sv


def run_word2vec_sharded(torch, card, cache, ids, host, mesh, tmp):
    """[word2vec-sharded] ``ShardedWord2Vec`` on the NCCL world of one:
    one epoch, its tables held to the plain host route's (the same
    pairs, negatives and alphas; ``hold_change``); ``save`` then
    ``restore`` into a fresh trainer gives the same rows bit for bit."""
    from deeplearning4j_tpu_torch.embeddings import ShardedWord2Vec

    kw = dict(layer_size=W2V_DIM, window=W2V_WINDOW, negative=W2V_NEG,
              batch_size=W2V_BATCH, epochs=1, seed=W2V_SEED, mesh=mesh)
    sw = ShardedWord2Vec(cache, ids, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sw.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lk = sw.lookup
    got = [torch.from_numpy(lk.t0.to_host()),
           torch.from_numpy(lk.t1n.to_host())]
    want = [host.lookup.syn0.cpu(), host.lookup.syn1neg.cpu()]
    init = make_w2v(cache, ids, device="cpu").lookup
    err, atol = hold_change(torch, "word2vec-sharded", got, want,
                            [init.syn0, init.syn1neg])
    path = f"{tmp}/w2v-sharded.npz"
    sw.save(path)
    back = ShardedWord2Vec(cache, ids, **kw)
    back.restore(path)
    same = (np.array_equal(back.lookup.t0.to_host(), got[0].numpy())
            and np.array_equal(back.lookup.t1n.to_host(), got[1].numpy()))
    if not same:
        raise RuntimeError("[word2vec-sharded] save/restore changed rows")
    res = {"world": mesh.data, "backend": mesh.backend,
           "words_per_s": sum(len(s) for s in ids) / wall,
           "max_abs_diff_vs_host_route": err, "tolerance": TWIN_TOLERANCE,
           "tightest_atol": atol, "restore_bitwise": True,
           "shard_bytes": lk.t0.shard_bytes(),
           "quarantined": sw._quarantined}
    print(f"[word2vec-sharded] {json.dumps(res)} card={card}")


def blogcatalog_graph():
    """A graph with BlogCatalog's counts (the DeepWalk paper's evaluation
    graph, not in the repo): 10,312 vertices and 333,983 distinct
    undirected edges drawn from ``RandomState(0)``."""
    from deeplearning4j_tpu_torch.graph import Graph

    rng = np.random.RandomState(0)
    n, m = DW_VERTICES, DW_EDGES
    pairs = np.zeros((0, 2), np.int64)
    while len(pairs) < m:
        u = rng.randint(0, n, 2 * m)
        v = rng.randint(0, n, 2 * m)
        e = np.stack([np.minimum(u, v), np.maximum(u, v)], 1)
        e = e[e[:, 0] != e[:, 1]]
        pairs = np.unique(np.concatenate([pairs, e]), axis=0)
    pairs = pairs[rng.permutation(len(pairs))[:m]]
    g = Graph(n, allow_multiple_edges=True)
    for a, b in pairs.tolist():
        g.add_edge(a, b)
    return g


def run_deepwalk(torch, card):
    """[deepwalk] ``DeepWalk.fit`` on the BlogCatalog-sized graph:
    vector 128, window 10, walk length 40, one walk a vertex (pairs/s);
    its CPU twin trains the first 256 walks from the same tables on the
    CPU and on the card, which must change them alike
    (``hold_change``)."""
    from deeplearning4j_tpu_torch.graph import DeepWalk
    from deeplearning4j_tpu_torch.graph.api import NoEdgeHandling
    from deeplearning4j_tpu_torch.graph.graph import generate_random_walks

    t0 = time.perf_counter()
    g = blogcatalog_graph()
    build_s = time.perf_counter() - t0
    kw = dict(vector_size=DW_DIM, window_size=DW_WINDOW, seed=DW_SEED)
    dw = DeepWalk(device="cuda", **kw)
    dw.initialize(g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dw.fit(g, walk_length=DW_WALK, epochs=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pairs = DW_VERTICES * (DW_WALK + 1 - 2 * DW_WINDOW) * 2 * DW_WINDOW
    vecs = dw.lookup_table.get_vertex_vectors()
    if not np.isfinite(vecs).all():
        raise RuntimeError("[deepwalk] vertex vectors are not finite")
    walks = generate_random_walks(g, DW_WALK, np.arange(DW_TWIN_WALKS),
                                  seed=DW_SEED + 7,
                                  mode=NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED)
    card_dw, cpu_dw = DeepWalk(device="cuda", **kw), DeepWalk(device="cpu",
                                                             **kw)
    for d in (card_dw, cpu_dw):
        d.initialize(g)
    start = [cpu_dw.lookup_table.vertex_vectors.clone(),
             cpu_dw.lookup_table.out_weights.clone()]
    for d in (card_dw, cpu_dw):
        d.fit_walks(walks)
    err, atol = hold_change(torch, "deepwalk", [
        card_dw.lookup_table.vertex_vectors, card_dw.lookup_table.out_weights],
        [cpu_dw.lookup_table.vertex_vectors, cpu_dw.lookup_table.out_weights],
        start)
    res = {"vertices": DW_VERTICES, "edges": DW_EDGES, "dim": DW_DIM,
           "window": DW_WINDOW, "walk_length": DW_WALK,
           "batch": dw.batch_size, "pairs": pairs,
           "pairs_per_s": pairs / wall, "fit_s": wall,
           "graph_build_s": build_s, "twin_walks": DW_TWIN_WALKS,
           "twin_max_abs_diff": err, "twin_tolerance": TWIN_TOLERANCE,
           "twin_tightest_atol": atol}
    print(f"[deepwalk] {json.dumps(res)} card={card}")


def run_glove(torch, card):
    """[glove] ``Glove.fit`` on a Zipf corpus from ``RandomState(3)``
    (1,000 sentences of 40 words over 1,000), D 100, window 5, 5 epochs
    (cut from the reference's 25), triples/s; the CPU twin fits the same
    triples from the same state, which must change W, W̃ and the two
    biases as on the card (``hold_change``)."""
    from deeplearning4j_tpu_torch.nlp.glove import Glove
    from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor

    sents = zipf_sentences(1000, 40, 1000, 3)
    cache = VocabConstructor(1).build_vocab_from_tokens(sents)
    ids = [np.asarray(cache.id_stream(s), np.int64) for s in sents]
    kw = dict(layer_size=100, window=5, epochs=GLOVE_EPOCHS, seed=5)
    gl = Glove(cache, ids, device="cuda", **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gl.fit()
    wall = time.perf_counter() - t0
    twin = Glove(cache, ids, device="cpu", **kw)
    start = [torch.from_numpy(a.copy()) for a in twin.state_numpy()[:4]]
    twin.fit()
    err, atol = hold_change(torch, "glove", [
        torch.from_numpy(a) for a in gl.state_numpy()[:4]],
        [torch.from_numpy(a) for a in twin.state_numpy()[:4]], start)
    n = len(gl.co.triples()[0])
    res = {"triples": n, "epochs": GLOVE_EPOCHS,
           "triples_per_s": n * GLOVE_EPOCHS / wall, "fit_s": wall,
           "loss": gl.last_loss, "twin_loss": twin.last_loss,
           "twin_max_abs_diff": err, "twin_tolerance": TWIN_TOLERANCE,
           "twin_tightest_atol": atol}
    print(f"[glove] {json.dumps(res)} card={card}")


def run_paragraph_vectors(torch, card):
    """[paragraph-vectors] DBOW ``ParagraphVectors`` over 1,000 labelled
    documents of 40 Zipf words (``RandomState(4)``), D 100, 5 epochs,
    words/s, and ``infer_vector`` of an unseen document; the CPU twin
    must change the tables and the inferred vector (from its start,
    ``epochs=0``) as the card does (``hold_change``)."""
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
        ParagraphVectors,
    )
    from deeplearning4j_tpu_torch.nlp.tokenization import LabelAwareIterator

    texts = [" ".join(s) for s in zipf_sentences(PV_DOCS, 40, 1000, 4)]
    labels = [f"doc{i}" for i in range(PV_DOCS)]

    def build(device):
        return (ParagraphVectors.Builder().layer_size(100).epochs(PV_EPOCHS)
                .batch_size(1024).seed(6).device(device)
                .iterate(LabelAwareIterator.from_texts(texts, labels))
                .build())

    pv = build("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pv.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    unseen = " ".join(zipf_sentences(1, 40, 1000, 99)[0])
    inferred = pv.infer_vector(unseen)
    twin = build("cpu")
    start = w2v_tables(torch, twin)
    twin.fit()
    err, atol = hold_change(
        torch, "paragraph-vectors",
        w2v_tables(torch, pv) + [torch.from_numpy(inferred)],
        w2v_tables(torch, twin) + [torch.from_numpy(
            twin.infer_vector(unseen))],
        start + [torch.from_numpy(twin.infer_vector(unseen, epochs=0))])
    words = PV_DOCS * 40
    res = {"documents": PV_DOCS, "epochs": PV_EPOCHS,
           "words_per_s": words * PV_EPOCHS / wall, "fit_s": wall,
           "nearest_labels_doc0": pv.nearest_labels("doc0", 3),
           "twin_max_abs_diff": err, "twin_tolerance": TWIN_TOLERANCE,
           "twin_tightest_atol": atol}
    print(f"[paragraph-vectors] {json.dumps(res)} card={card}")


def mlp_conf():
    """EmbeddingLayer(2000 -> 128) -> Dense 256 relu -> softmax output
    over 10 classes, Adam."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (
        DenseLayer,
        EmbeddingLayer,
        OutputLayer,
    )

    return (NeuralNetConfiguration.Builder().seed(12).learning_rate(1e-2)
            .updater("ADAM").list()
            .layer(EmbeddingLayer(n_in=MLP_VOCAB, n_out=W2V_DIM))
            .layer(DenseLayer(n_in=W2V_DIM, n_out=MLP_HIDDEN,
                              activation="relu"))
            .layer(OutputLayer(n_in=MLP_HIDDEN, n_out=10))
            .build())


def mlp_batch(seed):
    from deeplearning4j_tpu_torch.datasets import DataSet

    rng = np.random.RandomState(seed)
    x = rng.randint(0, MLP_VOCAB, (MLP_BATCH, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[x[:, 0].astype(np.int64) % 10]
    return DataSet(x, y)


def run_embedding_mlp(torch, card):
    """[embedding-mlp] EmbeddingLayer -> Dense(relu, the dense kernel) ->
    softmax at batch 1024: 5 Adam steps on one minibatch on the card
    (the score falls),
    each step launching ``matmul_block`` once, held to the CPU twin's
    scores within 1e-4 and repeated bitwise. Returns the launch counts
    of the steps (a main path)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch

    conf = mlp_conf()
    batches = [mlp_batch(0)] * MLP_STEPS
    net = MultiLayerNetwork(conf, device="cuda").init()
    init = {ln: {pn: t.cpu() for pn, t in lp.items()}
            for ln, lp in net.params.items()}
    dispatch.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = [float(net.fit_minibatch(b)) for b in batches]
    wall = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    want = {k: 0 for k in dispatch.KERNELS}
    want["matmul_block"] = MLP_STEPS
    if launches != want:
        raise RuntimeError(f"[embedding-mlp] {MLP_STEPS} steps launched "
                           f"{launches}")
    if not scores[-1] < scores[0]:
        raise RuntimeError(f"[embedding-mlp] the score did not fall: "
                           f"{scores}")
    twin = MultiLayerNetwork(conf, device="cpu").init(params=init)
    cpu = [float(twin.fit_minibatch(b)) for b in batches]
    np.testing.assert_allclose(scores, cpu, rtol=1e-4)
    again = MultiLayerNetwork(conf, device="cuda").init(params=init)
    if [float(again.fit_minibatch(b)) for b in batches] != scores or any(
            not torch.equal(t, again.params[ln][pn])
            for ln, lp in net.params.items() for pn, t in lp.items()):
        raise RuntimeError("[embedding-mlp] two card runs differ")
    res = {"batch": MLP_BATCH, "steps": MLP_STEPS, "scores": scores,
           "cpu_scores": cpu, "ms_per_step": wall / MLP_STEPS * 1e3,
           "launches": {k: v for k, v in launches.items() if v},
           "repeat_bitwise": True}
    print(f"[embedding-mlp] {json.dumps(res)} card={card}")
    return launches


def run_zero(torch, card, mesh, tmp):
    """[zero] ``DistributedTrainer(zero=True)`` on the NCCL world of one
    over the embedding MLP: two steps, ``write_model``, restore. The
    checkpoint's updater state is parameter-shaped and equal bit for bit
    to the replicated run's checkpoint; the restored model continues."""
    import io
    import zipfile

    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import DistributedTrainer
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model,
        write_model,
    )

    conf = mlp_conf()
    init = MultiLayerNetwork(conf, device="cpu").init().params
    paths = {}
    for zero in (False, True):
        net = MultiLayerNetwork(conf, device="cuda").init(params=init)
        tr = DistributedTrainer(net, mesh=mesh, zero=zero)
        for s in range(2):
            tr.fit_minibatch(mlp_batch(s))
        if zero and net._zero_layout != {"shards": 1}:
            raise RuntimeError(f"[zero] layout {net._zero_layout}")
        paths[zero] = f"{tmp}/zero-{zero}.zip"
        write_model(net, paths[zero])

    def npz(path):
        with zipfile.ZipFile(path) as zf:
            with np.load(io.BytesIO(zf.read("updaterState.npz"))) as f:
                return {k: f[k] for k in f.files}

    rep, zro = npz(paths[False]), npz(paths[True])
    if set(rep) != set(zro) or any(not np.array_equal(rep[k], zro[k])
                                   for k in rep):
        raise RuntimeError("[zero] the checkpoints' updater states differ")
    back = restore_model(paths[True], device="cuda")
    for ln, lp in back.params.items():
        for pn, p in lp.items():
            if any(m.shape != p.shape for m in back.updater_state[ln][pn]):
                raise RuntimeError(f"[zero] {ln}/{pn}'s moments are not "
                                   "parameter-shaped")
    score = float(back.fit_minibatch(mlp_batch(2)))
    if not np.isfinite(score):
        raise RuntimeError("[zero] the restored model's step is not finite")
    res = {"world": mesh.data, "steps": 2, "updater_leaves": len(rep),
           "checkpoint_bitwise_vs_replicated": True,
           "moments_parameter_shaped": True, "continued_score": score}
    print(f"[zero] {json.dumps(res)} card={card}")


def run_nlp(torch, card):
    """The NLP / embeddings slice: ``[word2vec]`` and ``[word2vec-host]``
    on bench.py's corpus, ``[deepwalk]``, ``[glove]``,
    ``[paragraph-vectors]``, ``[embedding-mlp]``, then
    ``[word2vec-sharded]`` and ``[zero]`` on an NCCL world of one formed
    through a file rendezvous in a temporary directory. Returns the
    launch counts of the main paths (the embedding MLP's steps)."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.parallel import (
        build_mesh,
        init_distributed,
        shutdown_distributed,
    )

    def timed(tag, fn, *args):
        t0 = time.perf_counter()
        out = fn(torch, card, *args)
        print(f"[{tag}] phase {time.perf_counter() - t0:.1f} s")
        return out

    cache, ids = w2v_corpus()
    timed("word2vec", run_word2vec, cache, ids)
    host = timed("word2vec-host", run_word2vec_host, cache, ids)
    timed("deepwalk", run_deepwalk)
    timed("glove", run_glove)
    timed("paragraph-vectors", run_paragraph_vectors)
    launches = timed("embedding-mlp", run_embedding_mlp)
    tmp = tempfile.mkdtemp(prefix="dl4j_nlp_")
    try:
        init_distributed(f"file://{tmp}/rdv", 1, 0, device="cuda",
                         timeout_s=120)
        mesh = build_mesh()
        if mesh.backend != "nccl":
            raise RuntimeError(f"[word2vec-sharded] formed {mesh.backend}")
        timed("word2vec-sharded", run_word2vec_sharded, cache, ids, host,
              mesh, tmp)
        timed("zero", run_zero, mesh, tmp)
    finally:
        shutdown_distributed()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.zoo import alexnet, lenet

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[env] card: {card}")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load()
    print(f"[env] kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds else 0:.2f} s;"
          f" 0 = library already built)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for model, conf, batch in (("lenet", lenet(), LENET_BUCKET),
                               ("lenet256", lenet(), LENET_TRAIN_BATCH),
                               ("alexnet", alexnet(), ALEXNET_BATCH)):
        for name, kind_, geo in kernel_shapes(conf, batch):
            rec = check_kernel(torch, F, model, name, kind_, geo, gen)
            records.append(rec)
            print(f"[kernel] {json.dumps(rec)}")
    for model, conf, batch in (("lenet256", lenet(), LENET_TRAIN_BATCH),
                               ("alexnet", alexnet(), ALEXNET_BATCH)):
        for name, kind_, geo in step_shapes(kernel_shapes(conf, batch)):
            if not kind_.startswith("conv_bwd"):
                continue
            rec = check_bwd_kernel(torch, model, name, kind_, geo, gen)
            records.append(rec)
            print(f"[kernel] {json.dumps(rec)}")

    for model, shapes in (("vgg16", vgg_shapes()),
                          ("resnet50", resnet_shapes()),
                          ("alexnet-train", alexnet_train_shapes())):
        for name, kind_, geo, names in shapes:
            if kind_.startswith("conv_bwd"):
                rec = check_bwd_kernel(torch, model, name, kind_, geo, gen)
            else:
                rec = check_kernel(torch, F, model, name, kind_, geo, gen)
            # a step launches the conv forward twice (the f32 recompute)
            rec.update(vertices=names, launches_per_step=len(names) * (
                2 if kind_ == "conv_block" else 1))
            records.append(rec)
            print(f"[kernel] {json.dumps(rec)}")

    for model, (T, b, n) in (("charrnn", (CHAR_TBPTT, CHAR_BATCH,
                                          CHAR_HIDDEN)),
                             ("charrnn-sample", (1, 1, CHAR_HIDDEN)),
                             ("saturated", SATURATED)):
        for rec in check_lstm_kernels(torch, model, T, b, n, gen):
            records.append(rec)
            print(f"[kernel] {json.dumps(rec)}")
    for rec in (check_flash_kernels(torch, F, gen)
                + check_transformer_matmuls(torch, gen)):
        records.append(rec)
        print(f"[kernel] {json.dumps(rec)}")
    # the embedding MLP's dense layer, launched once a step
    rec = check_kernel(torch, F, "embedding-mlp", "dense", "matmul_block",
                       {"m": MLP_BATCH, "k": W2V_DIM, "n": MLP_HIDDEN,
                        "activation": "relu"}, gen)
    rec["launches_per_step"] = 1
    records.append(rec)
    print(f"[kernel] {json.dumps(rec)}")
    check_routes(records)
    # the conv kernels' half-precision variants at ResNet-50's shapes
    half_records = check_half_kernels(torch, F, gen)
    for rec in half_records:
        print(f"[kernel] {json.dumps(rec)}")
    layers = []
    for model, n_in, (T, b, n) in (
            ("charrnn", CHAR_VOCAB, (CHAR_TBPTT, CHAR_BATCH, CHAR_HIDDEN)),
            ("charrnn", CHAR_HIDDEN, (CHAR_TBPTT, CHAR_BATCH, CHAR_HIDDEN)),
            ("saturated", SATURATED[2], SATURATED)):
        rec = lstm_layer_vs_cudnn(torch, model, T, b, n_in, n, gen)
        layers.append(rec)
        print(f"[layer] {json.dumps(rec)}")

    served = serve_lenet(torch, card)
    trained = train_lenet(torch, card)
    run_alexnet(torch, card)
    alex_train = run_alexnet_train(torch, card, records)
    ids, alphabet = survey_corpus()
    char_peep = run_charrnn(torch, card, True, ids, alphabet)
    char_seq = run_charrnn(torch, card, False, ids, alphabet)
    tokens = survey_bytes()
    lm, tx_fit = run_transformer(torch, card, tokens)
    run_transformer_twin(torch, card, tokens)
    tx_sample = sample_transformer(torch, card, lm, tokens, seed=7)
    tx_long = run_transformer_long(torch, card, lm, tokens, seed=8)
    tx_paths = (tx_fit, tx_sample, tx_long)
    vgg = run_vgg16(torch, card)
    conv_bn = run_conv_bn(torch, card)
    resnet, resnet_init, resnet_data = run_resnet50(torch, card)
    resnet_dp = run_resnet50_dp(torch, card, resnet_init, resnet_data)
    del resnet_init, resnet_data
    # half-precision training (each returns launches and variant counts)
    half_paths = [run_resnet50_bf16(torch, card), run_vgg16_bf16(torch, card),
                  run_transformer_bf16(torch, card, tokens),
                  run_f16_loss_scale(torch, card, tokens)]
    guarded = run_guard(torch, card)
    mega = run_megastep(torch, card)
    nlp = run_nlp(torch, card)
    half_launches = [launches for launches, _ in half_paths] + [guarded]
    half_variants = {}
    for _, variants in half_paths:
        for k, v in variants.items():
            half_variants[k] = half_variants.get(k, 0) + v

    kernels = []
    csrc = "deeplearning4j_tpu_torch/csrc/"
    # (source, TPU kernel, the main-path forward or step whose launches
    # the times sum: LeNet's serving forward at bucket 32 for the forward
    # kernels, one LeNet training step at batch 256 for the backward)
    sources = {
        "conv_block": (csrc + "conv_block.cu",
                       "deeplearning4j_tpu/ops/conv_block.py:104", "lenet."),
        "conv_bwd_data": (csrc + "conv_bwd.cu",
                          "deeplearning4j_tpu/ops/conv_block.py:104",
                          "lenet256."),
        "conv_bwd_w": (csrc + "conv_bwd.cu",
                       "deeplearning4j_tpu/ops/conv_block.py:184",
                       "lenet256."),
        "matmul_block": (csrc + "matmul_block.cu",
                         "deeplearning4j_tpu/ops/matmul_block.py:53",
                         "lenet."),
    }
    for k, (src, replaces, main_of) in sources.items():
        mine = [r for r in records if r["kernel"] == k]
        main = [r for r in mine if r["shape_of"].startswith(main_of)]
        # the launches run one after another: the least time is the sum
        # of their bounds, named by the launch that bounds the most
        bound_ms = sum(r["bound_ms"] for r in main)
        bound_by = max(main, key=lambda r: r["bound_ms"])["bound_by"]
        entry = {
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": (served[k] + trained[k] + sum(c[k] for c in tx_paths)
                         + vgg[k] + conv_bn[k] + resnet[k] + resnet_dp[k]
                         + alex_train[k] + mega[k] + nlp[k]
                         + sum(c[k] for c in half_launches)),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["kernel_ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sum(r["library_ms"] for r in main),
        }
        if k in INTENDED_ROUTES:  # the kernel route its main path took
            entry["kernel_route"] = "+".join(sorted(
                {r["kernel_route"] for r in main}))
        # VGG-16's, ResNet-50's and AlexNet's training steps at batch
        # 128: each shape's time by its launches a step, summed
        for model in ("vgg16", "resnet50", "alexnet-train"):
            recs = [r for r in mine if r["shape_of"].startswith(model + ".")]
            if not recs:
                continue
            tag = model.replace("-", "_")
            entry.update({f"{tag}_{key}_per_step": sum(
                r[key] * r["launches_per_step"] for r in recs)
                for key in ("kernel_ms", "plain_ms", "library_ms",
                            "bound_ms")})
            entry.update({f"{tag}_launches_per_step": sum(
                r["launches_per_step"] for r in recs),
                f"{tag}_route": "+".join(
                    sorted({r["kernel_route"] for r in recs}))})
        if k == "conv_block":  # AlexNet's five convs at batch 64, summed
            alex = [r for r in mine if r["shape_of"].startswith("alexnet.")]
            entry.update(alexnet_route="+".join(sorted(
                {r["kernel_route"] for r in alex})),
                alexnet_ms=sum(r["kernel_ms"] for r in alex),
                alexnet_library_ms=sum(r["library_ms"] for r in alex),
                alexnet_bound_ms=sum(r["bound_ms"] for r in alex))
        if k == "conv_bwd_w":  # each layer of the step, library beside
            for r in main:
                layer = r["shape_of"].split(".")[1]
                entry.update({f"{layer}_ms": r["kernel_ms"],
                              f"{layer}_library_ms": r["library_ms"],
                              f"{layer}_bound_ms": r["bound_ms"]})
        if k == "matmul_block":  # the transformer's input projection
            tx_in = next(r for r in mine
                         if r["shape_of"] == "transformer.input")
            entry.update(transformer_route=tx_in["kernel_route"],
                         transformer_ms=tx_in["kernel_ms"],
                         transformer_library_ms=tx_in["library_ms"])
            # and the embedding MLP's dense layer (one launch a step)
            mlp = next(r for r in mine
                       if r["shape_of"] == "embedding-mlp.dense")
            entry.update({f"embedding_mlp_{key}": mlp[key] for key in (
                "kernel_route", "kernel_ms", "plain_ms", "library_ms",
                "bound_ms", "max_abs_err")})
        kernels.append(entry)
    # the LSTM kernels: one launch at the char-RNN's chunk (T 50, b 32,
    # n 200) in the variant its training runs (the zoo model's peephole
    # cell, the sequence forward that writes c_seq); launches of both
    # char-RNN main paths. library_ms: torch.nn.LSTM (cuDNN), a
    # layer-level time (input projection included) at n_in 200, beside
    # the port's own layer time (port_fwd_ms / port_bwd_ms) from the same
    # [layer] record
    cudnn = next(r for r in layers if r["shape_of"] == "charrnn"
                 and r["n_in"] == CHAR_HIDDEN)
    for k, src, line, variant, lib in (
            ("lstm_cell", "lstm_cell.cu", 28, "peephole", None),
            ("lstm_seq_fwd", "lstm_seq.cu", 202, "c_seq",
             cudnn["cudnn_fwd_ms"]),
            ("lstm_seq_bwd", "lstm_seq.cu", 217, "", cudnn["cudnn_bwd_ms"])):
        mine = [r for r in records if r["kernel"] == k]
        main = next(r for r in mine if r["shape_of"] == "charrnn"
                    and r["variant"] == variant)
        entry = {
            "name": k, "route": "cuda", "source": csrc + src,
            "replaces": f"deeplearning4j_tpu/ops/lstm_cell.py:{line}",
            "launches": char_peep[k] + char_seq[k],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": lib,
        }
        entry["kernel_route"] = main["kernel_route"]
        if k != "lstm_cell":  # the sequence kernels' own layer time
            side = k[-3:]  # fwd / bwd
            entry[f"port_{side}_ms"] = cudnn[f"port_{side}_ms"]
        kernels.append(entry)
    # the transformer's kernels: f32 at the main path's shapes (flash
    # attention's resident entry and the residual matmul at the training
    # shape, the streamed entry at t 16384); launches of the transformer's
    # main paths (fit, sampling, long-context output). library_ms:
    # scaled_dot_product_attention, torch.addmm + the residual add
    for k, src, replaces, shape_of in (
            ("flash_attention", "flash_attention.cu",
             "deeplearning4j_tpu/ops/flash_attention.py:32", "transformer"),
            ("flash_attention_streamed", "flash_attention.cu",
             "deeplearning4j_tpu/ops/flash_attention.py:180", "long"),
            ("matmul_block_residual", "matmul_block.cu",
             "deeplearning4j_tpu/ops/matmul_block.py:59",
             "transformer.ffn2")):
        mine = [r for r in records if r["kernel"] == k
                and r.get("dtype", "float32") == "float32"]
        main = next(r for r in mine if r["shape_of"] == shape_of)
        entry = {
            "name": k, "route": "cuda", "source": csrc + src,
            "replaces": replaces,
            "launches": (sum(c[k] for c in tx_paths)
                         + sum(c[k] for c in half_launches)),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
        }
        if k in INTENDED_ROUTES:
            entry["kernel_route"] = main["kernel_route"]
        kernels.append(entry)
    # the conv kernels' half-precision variants: ResNet-50's step at
    # batch 128 in bf16, each shape's time by its launches a step; the
    # launches of every half-precision main path by variant
    for k, variant, src, replaces in (
            ("conv_block", "bf16", "conv_block.cu",
             "deeplearning4j_tpu/ops/conv_block.py:104"),
            ("conv_block", "bf16->f32", "conv_block.cu",
             "deeplearning4j_tpu/ops/conv_block.py:104"),
            ("conv_bwd_w", "bf16", "conv_bwd.cu",
             "deeplearning4j_tpu/ops/conv_block.py:184")):
        mine = [r for r in half_records
                if r["kernel"] == k and r["variant"] == variant]

        def per_step(key, recs=mine):
            return sum(r[key] * r["launches_per_step"] for r in recs)
        kernels.append({
            "name": f"{k}[{variant}]", "route": "cuda",
            "source": csrc + src, "replaces": replaces,
            "launches": half_variants.get(f"{k}[{variant}]", 0),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": per_step("kernel_ms"), "plain_ms": per_step("plain_ms"),
            "bound_ms": per_step("bound_ms"),
            "bound_by": max(mine, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": per_step("library_ms"),
            "bound_fp32_simt_ms": per_step("bound_fp32_simt_ms"),
            "shape_of": "resnet50-bf16 step, batch 128",
            "launches_per_step": sum(r["launches_per_step"] for r in mine),
            "kernel_route": "+".join(sorted({r["kernel_route"]
                                             for r in mine}))})
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
