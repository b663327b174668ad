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
   ``[transformer-twin]`` the same widths at 6 layers and batch 4, 2
   steps against the CPU twin;
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
   on-device epoch generation, each epoch a CUDA-graph replay beside the
   eager epoch: words/s (best of 3 windows of 20 epochs; the eager
   route's of 2), the cold rate, the capture's seconds and launches,
   device ms an epoch and busy share both ways, peak memory, the graph
   route bitwise the eager one over 2 epochs, two fits from the seed
   equal bit for bit, one epoch held to the CPU twin on the card's
   draws, the VP-tree nearest words the flat scan's;
   ``[nlp-periphery]`` (on ``[word2vec]``'s tables) k-means on the card
   at 100,000 x 128, K 64, against its CPU twin, ``StaticWord2Vec``
   and TF-IDF over the corpus; ``[word2vec-host]`` one epoch of
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
   poisoned run at K = 6 (the same skipped steps and trees);
12. the training runtime (main paths): ``[resnet50-runtime]`` ResNet-50
   at 224 x 224, batch 128, f32 through ``DistributedTrainer`` on an
   NCCL world of one: A, the per-step ``fit`` of 8 batches through the
   dispatch window (launches exact, 106 / 52 / 53 a step); B,
   ``fit(prefetch=2, megastep=2)`` with a batch validator and quarantine
   store, async checkpoints every 2 steps and a preemption notice after
   step 4: the NaN batch quarantined, the emergency checkpoint at step 4
   (stall, write and save times, bytes, the chunk's peak memory, the
   prefetch wait); C, a fresh trainer resumes it and fits batches 5-8 as
   chunks: bitwise run A (host ms a step and busy share of A and C, the
   restore time); ``[lenet-rollback]`` ``DivergenceGuard("rollback")``
   on [train]'s LeNet-5 restores the step-4 checkpoint bitwise, and a
   SKIP guard read 2 steps late is bitwise one read at once;
13. the scan path (main paths; every earlier phase runs per step,
   ``scan_chunk = 1``, as ``per_step_loop`` sets): ``[lenet-cached]`` LeNet-5
   at batch 256 fits 16 minibatches as a list for 3 epochs at the
   default ``scan_chunk`` of 16 (one chunk, captured once, replayed with
   the data on the card), ``[vgg16-cached]`` the VGG-16 graph at batch
   128, 8 minibatches, 2 epochs, ``scan_chunk = 4``, and
   ``[charrnn-fused]`` / ``[charrnn-seq-fused]`` the char-RNN with and
   without peepholes, 3 minibatches x 2 epochs on the device-cached
   fused-TBPTT plan (12 TBPTT chunks a replay): each bitwise its
   ``scan_chunk = 1`` fit (the carry too), with launches counted at
   capture, examples/s, device ms a step, the busy share both ways and
   the peak memory; ``[telemetry]`` a LeNet-5 fit under a global tracer
   with a JSONL sink, an active ``StepProfiler``, a ``TelemetryListener``
   and a ``ProfilerListener`` over iterations [3, 6) (its trace names the
   port's conv and dense kernels), with a checkpoint save and restore:
   the split sums to each record's wall time within 1 %, MFU in (0, 1]
   at the card's peak, the memory gauges, the Prometheus text parses;
   then a LeNet ``ModelServer`` with a tracer: one trace id a request.
14. the elastic control plane and the default fit (main paths):
   ``[elastic-resnet50]`` ResNet-50 (batch 128, f32) on an NCCL world of
   one formed over a real ``LeaseCoordinator``'s rendezvous: A,
   ``DistributedTrainer`` for 8 steps; B, ``HostElasticTrainer(
   snapshot_every=4)``, a coordinator barrier a step, bitwise A (the
   barrier's round trip, the snapshot push, host and device ms a step
   and the busy share beside A's); C, the coordinator stopped after step
   5: the retries exhaust within the agent's bound, a checkpoint, then
   ``PreemptedException(step=5, reason="coordinator-lost")`` (exit 75);
   a fresh model resumes it and fits steps 6-8 bitwise A;
   ``[elastic-storm]`` LeNet-5 (global batch 256, 12 minibatches) under
   ``HostElasticTrainer`` in two rank processes on a gloo group over the
   card, rank 1 SIGKILLed after step 7: rank 0 exits 0 with one
   recovery to the step-4 snapshot and 12 steps, bitwise a process
   replaying the snapshot at survivor width (kill to plan, recovery ms,
   steps lost, examples/s before and after); ``[default-fit]`` the
   default ``fit`` (``scan_chunk`` 16, one CUDA-graph chunk of 4
   minibatches) of ResNet-50, the transformer LM and AlexNet with
   dropout, each bitwise its ``scan_chunk = 1`` fit (device ms a step,
   the busy share, peak memory, the capture's seconds).
15. the serving tier (main paths): ``[fleet]`` one ``ModelServer`` over
   VGG-16 (the default tenant, restored from a ``CheckpointManager``),
   LeNet-5 and ResNet-50 at 224 x 224, f32, ``max_device_models=2``: a
   ResNet-50 evict -> fault-in bitwise, seeded concurrent HTTP traffic
   over the three with a VGG-16 hot reload in the middle (every answer
   against its version's CPU twin, zero 5xx, the shape counters flat),
   an overload's adaptive ``Retry-After``, the breaker opened and
   closed, and a ``ServingRouter`` over two servers losing no request
   when one stops (per-tenant p50 / p99, requests/s, page-in / page-out
   ms and bytes, reload ms); ``[aot-restart]`` LeNet-5 and ResNet-50
   saved with a serving bundle and served by a fresh process on an empty
   kernel-library cache: no nvcc build, answers bitwise this process's,
   boot-to-ready seconds beside this run's build, and a corrupt artifact
   counted in ``aot_fallback_total``.
16. the continuous-learning loop, early stopping and evaluate (main
   paths): ``[loop]`` LeNet-5 (Adam, batch 256) under a
   ``ContinualTrainer`` publishing every 8 steps with the serving bundle,
   a ``ModelServer`` on its store, a ``Promoter`` and 4 HTTP clients:
   A a good candidate shadowed, canaried, promoted and sealed (ms from
   publish to each state, agreement, p99 delta, answers against a CPU
   twin); B a byte-flipped candidate quarantined; C a candidate with
   rolled classes rejected; D a regression bomb promoted and rolled back
   once the clients' pixel (0, 0) turns hot (no new shape, no 5xx, no
   request lost, answers bitwise the pre-bomb version's); E a promoter
   killed after journaling ``canarying``, recovered forward by a fresh
   one; F a trainer resumed from the store publishing bitwise an
   uninterrupted trainer's parameters. ``[earlystop]``
   ``EarlyStoppingTrainer`` on LeNet-5 (best score against its CPU
   twin, the best model's accuracy); ``[evaluate]``
   ``ComputationGraph.evaluate`` and ``ROCMultiClass`` of VGG-16 at
   batch 128 against its CPU twin.
17. the row-sharded trainer (a main path, after every phase that forms
   a world in this process): ``[semb-dp]`` SparseEmbeddingLayer(1,048,576
   -> 128) -> Dense 256 relu (``matmul_block``) -> softmax over 10, Adam,
   on two gloo ranks sharing the card, 8 steps of 1024 Zipf ids: half
   the table a rank, each table's change against a replicated world of
   one, a step-4 checkpoint resumed at width 1 bitwise the world of
   one's own, and ``ClusterWord2Vec`` (1 epoch of bench.py's corpus)
   against one process.
18. the networks of the MoE / GoogLeNet / graph-RNN slice (main paths,
   after ``[evaluate]``; NETWORK_PATHS): ``[googlenet]`` the zoo's
   GoogLeNet at 224 x 224, batch 128, f32 (``output`` on uint8 pixels, a
   batch-4 twin with every conv call held on its operands, one step's
   launches exact, 6 steps; its 146 distinct step shapes among the
   ``[kernel]`` records, ``googlenet.``); ``[moe-transformer]`` the LM
   of bench.py:866 at 6 of its 12 layers with a Switch MoE of 4 experts
   in every block (each
   MoE call of a step held against the dense plain version and its
   routing against the CPU's, 20 steps, the default fit as one
   CUDA-graph chunk bitwise its per-step fit, ``output``, KV-cache
   sampling against the CPU twin's stream); ``[moe-ep]``
   ``ExpertParallelMoE`` over an NCCL world of one, bitwise the
   single-device MoE; ``[graph-charrnn]`` the char-RNN as a
   ComputationGraph (graph TBPTT, ``rnn_time_step``) with and without
   peepholes, bitwise the ``MultiLayerNetwork`` one; ``[conv-lstm]``
   LeNet's conv stages over 16-frame sequences (``RnnToCnn``,
   ``CnnToRnn``, ``RnnToFeedForward``) into GravesLSTM 200 (its 5
   distinct conv shapes among the records, ``conv-lstm.``).
19. the last of the distribution slice (main paths, after the networks;
   WORLD_PHASES on one spawned world of two gloo ranks sharing the
   card, its start paid once): ``[alexnet-tp]`` the zoo's AlexNet at
   full width (224 x 224, 1000 classes, batch 128, dropout 0.5) under
   ``DistributedTrainer(build_mesh(data=1, model=2),
   tensor_parallel=True)``, 4 steps held against the same 4 steps of a
   world of one from the same seed (scores to TP_SCORE_RTOL, every
   weight within TP_SHARE of its move, ``check_twin_step``), each
   rank's launches exact, host and device ms
   a step (its shard shapes among the ``[kernel]`` records,
   ``alexnet-tp.``); ``[ring-attention]`` the ``[transformer]`` phase's
   12 trained blocks as ``TransformerBlock(seq_axis="seq",
   seq_axis_size=2)``: the forward of 16,384 bytes' states (8,192 a
   rank) and one backward of the next-byte loss at 16 x 512 (256 a
   rank) held against the unsharded blocks; ``[gpipe]`` two stages of
   the dense kernel (relu, 4096 -> 4096) on batch 128 as 4
   microbatches, ``apply`` and two ``train_step``s against the serial
   composition (its m 32 shape among the records, ``gpipe.``); then in
   this process ``[cluster]`` ``ClusterDl4jMultiLayer`` over LeNet-5
   (SGD), 4 workers x 64 averaging every step, against one machine on
   the concatenated batch, the sharded ``evaluate`` against the plain
   one, and ``ClusterEarlyStoppingTrainer`` for 3 epochs.
20. the rest of ``fit`` (main paths, after ``[cluster]``; FIT_PATHS):
   ``[deep-ae]`` the DeepAutoEncoder of deeplearning4j-examples (9 RBMs
   784 -> 1000 -> 500 -> 250 -> 100 -> 30 -> ... -> 1000, a sigmoid
   output 1000 -> 784, 2,882,028 parameters) on binarized synthetic
   MNIST in batches of 1000: one CD-1 iteration of each RBM and two line
   gradient descent steps held against the CPU twin, then ``fit``
   (pretraining, then a solver step a batch), zero kernel launches, the
   score falling; ``[vae]`` the MNIST VAE (784 -> 2, 256 / 256,
   535,828 parameters, RMSPROP, batch 128): step one against the twin,
   ``fit`` (pretraining only), the negative ELBO falling,
   ``reconstruction_probability`` and ``generate_at_mean_given_z`` over
   a 10 x 10 grid against the twin; ``[lenet-lbfgs]`` LeNet-5 at full
   width under LBFGS and CONJUGATE_GRADIENT, batch 256: two steps against
   the twin (the same accepted alpha), each ``fit_minibatch``'s kernel
   launches exactly its line-search trials' (``solver_step_launches``).
   Each times its steps and profiles one off its main path (device ms,
   busy share).
21. model import and the kernel tuner (main paths, after the rest of
   ``fit``; TUNE_PATHS): ``[keras-vgg16]`` Keras 1.2's VGG-16
   (``VGG16(include_top=True)``'s layers as a Sequential config, ``th``,
   224 x 224 x 3, 1000 classes, 138,357,544 parameters) imported by
   ``modelimport.keras`` from its config JSON and seeded Keras-layout
   weights: the import exact, ``output`` at batch 16 with every conv and
   dense kernel call held against its plain version on its operands, a
   batch-2 CPU twin of the same import at kernel_tols, 2 ``fit`` steps
   at batch 16 with each step's launches exact, forward and step ms,
   images/s, device ms, busy share, peak memory (its 28 distinct step
   shapes among the ``[kernel]`` records, ``keras-vgg16.``);
   ``[autotune]`` two subprocesses on one temporary tuning cache: with
   ``DL4J_TPU_TUNE=on`` every kernel shape of that forward and step is
   measured (heuristic, winner and the plans measured printed, no winner
   slower than its heuristic as measured) and persisted; with
   ``cached`` the same step measures nothing, runs the persisted
   winners, each kernel call held against its plain version; then an
   entry with a changed torch version is refused as stale, counted, and
   resolved to the heuristic.
22. the host periphery (main paths, after the tuner; PERIPHERY_PATHS):
   ``[ui]`` the zoo's AlexNet (224 x 224, batch 128, f32) fits 10 steps
   under ``StatsListener(frequency=5, collect_histograms=True)`` (to an
   ``InMemoryStatsStorage``, a ``FileStatsStorage`` and, through a
   ``RemoteUIStatsStorageRouter``, a second ``UIServer``) and
   ``ConvolutionalIterationListener(frequency=5)`` (its batch-1 kernel
   calls held on their operands; the ``alexnet-b1.`` records), both on a
   ``UIServer`` at port 0: scores equal the net's, magnitudes the
   card's f64 means within numpy's f32 rounding of a mean, every
   endpoint 200 and the card named,
   the grids within 1 gray level of the plain batch-1 forward's tiles
   (read with the script's own PNG reader), the step's ms with and
   without a sampled report; ``[ui-chunk]`` LeNet-5 (batch 256) through
   the default fit's CUDA-graph chunks with the conv listener: one
   capture, two replays, the grids of the last minibatch, the snapshot
   unchanged by a later fill; ``[tsne]`` ``plot.Tsne`` on the card at N
   5,000 x d 128 (10 clusters), 1,000 iterations: its first 10 steps
   each held to the CPU's, the KL falling, 10-NN cluster agreement >=
   0.9, ms an iteration, the host joint P's seconds, peak memory;
   ``[stream]`` 20 LeNet-5 minibatches over a loopback
   ``NDArrayPublisher`` -> ``NDArrayConsumer`` ->
   ``StreamingDataSetIterator`` -> ``fit``, bitwise a list-fed fit
   (examples/s, busy share), one POST to ``streaming.ModelServer``;
   ``[cloud-data]`` the same minibatches as shards in a
   ``LocalObjectStore`` through ``CloudDataSetIterator``, bitwise;
   ``[native]`` the C++ loader built from the checkout, bit for bit its
   numpy route at MNIST's 60,000 rows and a CIFAR-10 batch, both timed
   (the numpy route refused).

``python3 chip_smoke.py --phases tag[,tag...]`` runs the named phases
alone (and the phases they read: ``[transformer]`` for the ring and
the sampling phases, ``[resnet50]`` for ``[resnet50-dp]``; ``kernels``
names the kernel checks, ``nlp`` the embeddings phases), for work on
a few phases: the kernels are still built, and its kernels line (the
same builder as a run of every phase, ``kernels_line``) lists only the
kernels its phases launched or made records of, the main path's times
null where it made none of their records.

The last lines are the card line, one JSON object with the per-kernel
numbers, and ``{"ok": true, "device": {...}}``. Exits non-zero without
a CUDA device, and when the port's package is not beside it.
"""

import contextlib
import faulthandler
import http.client
import importlib
import json
import os
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
CHAR_MINIBATCHES = 16
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
TWIN_LAYERS = 6  # [transformer-twin]'s depth, cut from 12 for time
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
W2V_PROFILED = 2  # eager epochs under the profiler, replays under events
W2V_TWIN_SENTENCES = 1000  # the host route's CPU twin, cut
# DeepWalk on a graph of BlogCatalog's counts (the DeepWalk paper's)
DW_VERTICES = 10312
DW_EDGES = 333983
DW_DIM = 128
DW_WINDOW = 10
DW_WALK = 40
DW_SEED = 7
DW_TWIN_WALKS = 256
GLOVE_EPOCHS = 3
PV_DOCS = 1000
PV_EPOCHS = 5
# the embedding MLP: EmbeddingLayer(2000 -> 128) -> Dense 256 -> softmax
MLP_VOCAB = 2000
MLP_BATCH = 1024
MLP_HIDDEN = 256
MLP_STEPS = 5
# [semb-dp]: SparseEmbeddingLayer(1,048,576 -> 128) -> Dense 256 relu ->
# softmax over 10, Adam, on two gloo ranks on one card: a global batch of
# 1024 Zipf ids (exponent 1.0), 8 steps, a checkpoint at step 4
SEMB_VOCAB = 1 << 20
SEMB_BATCH = 1024
SEMB_STEPS = 8
SEMB_SAVE_AT = 4
SEMB_TIMEOUT_S = 600
SEMB_W2V_EPOCHS = 1  # ClusterWord2Vec's epochs, cut from 2 for time
# [nlp-periphery]: k-means over seeded blobs
KMEANS_ROWS = 100_000
KMEANS_DIM = 128
KMEANS_K = 64
KMEANS_ITERS = 3
# a CPU twin holds each table's change within this share of the twin's
# largest change (f32 both sides, sums in another order)
TWIN_REL = 1e-3
# the timing window of each [kernel] record of a training step's
# distinct shapes (VGG-16, ResNet-50, AlexNet, GoogLeNet, the conv ->
# LSTM net) and of the half-precision conv records (50 ms before the
# script held these networks)
KERNEL_WINDOW_MS = 15.0
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


def per_step_loop(model):
    """``model`` on the per-step loop (``scan_chunk = 1``): the phases
    of the earlier slices count one step's launches and time one step,
    which the engines' default scan path (16 minibatches a CUDA-graph
    replay, launches counted once at capture) would change."""
    model.scan_chunk = 1
    return model


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


def graph_ms(torch, fn, reps: int = 10, window_ms: float = 50.0) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a
    CUDA graph, replayed until ~``window_ms`` have run, timed with events
    (so host launch overhead does not count)."""
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
    n = max(1, min(200, int(window_ms / max(start.elapsed_time(end),
                                            1e-3))))
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


def check_bwd_kernel(torch, model, name, kind, geo, gen,
                     window_ms: float = 50.0):
    """A backward kernel vs its plain version on the card at ``geo``;
    returns one record with the error, the times (each over a
    ``window_ms`` timing window) and the bound."""
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
    ms = graph_ms(torch, kernel, window_ms=window_ms)
    plain_ms = graph_ms(torch, plain, window_ms=window_ms)
    library_ms = graph_ms(torch, library, window_ms=window_ms)
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


def check_kernel(torch, F, model, name, kind, geo, gen,
                 window_ms: float = 50.0):
    """Kernel vs plain version on the card at ``geo``; returns one
    record with the error, the times (each over a ``window_ms`` timing
    window) and the bound."""
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
            y = torch.addmm(b, x, w)
            return torch.relu_(y) if act == "relu" else y
        flops = 2.0 * m * k * n
        nbytes = 4.0 * (x.numel() + w.numel() + b.numel() + m * n)
        shape = {"m": m, "k": k, "n": n}
    if act not in ("relu", "identity"):
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
        ms = graph_ms(torch, kernel, window_ms=window_ms)
        plain_ms = graph_ms(torch, plain, window_ms=window_ms)
        library_ms = graph_ms(torch, library, window_ms=window_ms)
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

    net = per_step_loop(MultiLayerNetwork(lenet(), device="cuda").init())
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
    net = per_step_loop(MultiLayerNetwork(conf, device="cuda").init())
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
    again = per_step_loop(MultiLayerNetwork(conf, device="cuda").init(params=init))
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
    model = per_step_loop(MultiLayerNetwork(conf, device="cuda").init(params=init))
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

    net = per_step_loop(MultiLayerNetwork(alexnet(), device="cuda").init())
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
    net = per_step_loop(MultiLayerNetwork(conf, device="cuda").init())
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
    a = per_step_loop(MultiLayerNetwork(conf, device="cuda").init(params=init))
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
    again = per_step_loop(MultiLayerNetwork(conf, device="cuda").init(params=init))
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
    model = per_step_loop(MultiLayerNetwork(conf, device="cuda").init(params=init))
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
    probe = per_step_loop(MultiLayerNetwork(conf, device="cuda").init(params=init))
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
    net = per_step_loop(ComputationGraph(conf, device="cuda").init())
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
    a = per_step_loop(ComputationGraph(conf, device="cuda").init(params=init))
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
    again = per_step_loop(ComputationGraph(conf, device="cuda").init(params=init))
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
    model = per_step_loop(ComputationGraph(conf, device="cuda").init(params=init))
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

    net = per_step_loop(MultiLayerNetwork(conv_bn_conf(), device="cuda").init())
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
    net = per_step_loop(ComputationGraph(conf, device="cuda").init())
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
    a = per_step_loop(ComputationGraph(conf, device="cuda").init(params=init))
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
    again = per_step_loop(ComputationGraph(conf, device="cuda").init(params=init))
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
    model = per_step_loop(ComputationGraph(conf, device="cuda").init(params=init))
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
        plain = per_step_loop(
            ComputationGraph(conf, device="cuda").init(params=init))
        plain_scores, plain_ms = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain_scores.append(float(plain.fit_minibatch(
                batches[i % len(batches)])))
            plain_ms.append((time.perf_counter() - t0) * 1e3)
        model = per_step_loop(
            ComputationGraph(conf, device="cuda").init(params=init))
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
            g = per_step_loop(
                ComputationGraph(conf, device="cuda").init(params=init))
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
                ms = graph_ms(torch, kernel, window_ms=KERNEL_WINDOW_MS)
                plain_ms = graph_ms(torch, plain, window_ms=KERNEL_WINDOW_MS)
                library_ms = graph_ms(torch, library,
                                      window_ms=KERNEL_WINDOW_MS)
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
    init_net = per_step_loop(ComputationGraph(conf, device="cuda").init())
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
    a = per_step_loop(ComputationGraph(conf, device="cuda").init(params=init))
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

    model = per_step_loop(ComputationGraph(conf, device="cuda").init(params=init))
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
    net = per_step_loop(ComputationGraph(conf, device="cuda").init())
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
    model = per_step_loop(ComputationGraph(conf, device="cuda").init(params=init))
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

    net = per_step_loop(MultiLayerNetwork(
        transformer_lm(compute_dtype="bfloat16", **TX), device="cuda").init())
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

    net = per_step_loop(MultiLayerNetwork(transformer_lm(
        compute_dtype="float16", loss_scale=F16_SCALE, **TX),
        device="cuda").init())
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
    net = per_step_loop(MultiLayerNetwork(conf, device=device).init())
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
            net = per_step_loop(
                MultiLayerNetwork(conf, device="cuda").init(params=init))
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
    a1 = per_step_loop(MultiLayerNetwork(narrow_alexnet(), device="cuda").init())
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
        net = per_step_loop(
            MultiLayerNetwork(conf, device="cuda").init(params=init))
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


# --- the training runtime (checkpoints, resume, preemption, prefetch,
# batch validation, the dispatch window, the trainer's megastep) --------

RUNTIME_STEPS = 8      # run A's batches; run B stops at RUNTIME_PREEMPT
RUNTIME_PREEMPT = 4    # the simulated notice fires after this step
RUNTIME_POISON_AFTER = 3  # the NaN batch follows this many clean ones
RUNTIME_K = 2
ROLLBACK_STEPS = 8
ROLLBACK_NAN_STEP = 4  # minibatch 5 carries a NaN


def host_trees(model) -> dict:
    """Host copies of ``snapshot(model)`` (parameters, updater moments,
    layer state) and the iteration count."""
    out = {k: v.cpu() for k, v in snapshot(model).items()}
    out["iteration_count"] = model.iteration_count
    return out


def same_as_host(torch, before, model) -> bool:
    """``model``'s trees and iteration count bitwise ``before``
    (``host_trees``)."""
    now = host_trees(model)
    return now.keys() == before.keys() and all(
        (now[k] == v) if k == "iteration_count" else torch.equal(now[k], v)
        for k, v in before.items())


def hist_quantile(fam, q: float):
    """The upper bound of the bucket of a registry histogram that holds
    its ``q`` quantile (the histogram keeps counts by bucket only)."""
    inst = fam._default()
    total = inst.count
    if not total:
        return None
    for bound, cum in inst.cumulative():
        if cum >= q * total:
            return bound
    return None


class StepClock:
    """A listener noting the host time of each ``iteration_done``."""

    def __init__(self):
        self.steps = []

    def iteration_done(self, model, iteration):
        self.steps.append(time.perf_counter())


class ChunkClock:
    """A listener noting the host time of each chunk's readback."""

    def __init__(self):
        self.chunks = []

    def chunk_done(self, model, it0, k, host):
        self.chunks.append((time.perf_counter(), k))


def runtime_world(device, tmp):
    """A world of one (NCCL on the card, gloo on the CPU) through a file
    rendezvous in ``tmp``; returns its mesh."""
    from deeplearning4j_tpu_torch.parallel import (
        build_mesh,
        init_distributed,
    )

    init_distributed(f"file://{tmp}/rdv", 1, 0, device=device,
                     timeout_s=120)
    return build_mesh()


def run_resnet50_runtime(torch, card, device="cuda", conf=None,
                         batch=RESNET_BATCH, hw=224):
    """[resnet50-runtime] the training runtime under ResNet-50 at 224 x
    224, batch 128, f32 (the zoo's ``ComputationGraph``, NESTEROVS),
    through ``DistributedTrainer`` on an NCCL world of one, three runs
    from the same seeded weights and batches: A, the yardstick, the
    per-step ``fit`` over 8 batches through the dispatch window (host
    copies of its trees kept, the model freed); B, ``fit(prefetch=2,
    megastep=2, validator=BatchValidator(BatchSchema.from_model),
    quarantine=QuarantineStore)`` over the batches with a NaN batch after
    the third, a ``CheckpointListener`` of an async ``CheckpointManager``
    every 2 steps and a ``PreemptionHandler`` notified after step 4: the
    NaN batch is quarantined without a step, the emergency save at the
    chunk boundary writes step 4 and ``PreemptedException.step`` is 4;
    C, a fresh model and trainer ``resume`` the manager (step 4) and fit
    batches 5-8 with ``prefetch=2, megastep=2``: its trees and iteration
    count bitwise run A's. Each chunk is one CUDA-graph replay of the
    trainer's step, its all-reduce inside. Returns the launch counts of
    the three runs. ``device`` / ``conf`` / ``batch`` / ``hw`` cut it
    for a rehearsal on the CPU."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.datasets.validate import (
        BatchSchema,
        BatchValidator,
        QuarantineStore,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.observability.metrics import (
        MetricsRegistry,
        default_registry,
    )
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.parallel import (
        DistributedTrainer,
        shutdown_distributed,
    )
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointListener,
        CheckpointManager,
    )
    from deeplearning4j_tpu_torch.resilience.preemption import (
        PreemptedException,
        PreemptionHandler,
    )
    from deeplearning4j_tpu_torch.zoo import resnet50

    cuda = device == "cuda"
    conf = conf if conf is not None else resnet50(learning_rate=0.01)
    rng = np.random.RandomState(23)
    batches = [DataSet(rng.randint(0, 256, (batch, 3, hw, hw),
                                   dtype=np.uint8),
                       np.eye(1000, dtype=np.uint8)[rng.randint(0, 1000,
                                                                batch)])
               for _ in range(RUNTIME_STEPS)]
    poison = batches[RUNTIME_POISON_AFTER].features.astype(np.float32)
    poison[1, 2, 3, 4] = np.nan
    poisoned = (batches[:RUNTIME_POISON_AFTER]
                + [DataSet(poison, batches[RUNTIME_POISON_AFTER].labels)]
                + batches[RUNTIME_POISON_AFTER:])
    init = ComputationGraph(conf, device="cpu").init().params
    tmp = tempfile.mkdtemp(prefix="dl4j_runtime_")
    launches = {k: 0 for k in dispatch.KERNELS}
    res = {"batch": batch, "hw": hw, "world": 1}
    handler = None

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def fresh(mesh):
        model = per_step_loop(
            ComputationGraph(conf, device=device).init(params=init))
        return model, DistributedTrainer(model, mesh=mesh,
                                         batch_stats="sync")

    def count(tag, per_steps=None):
        got = dispatch.launch_counts()
        for k, v in got.items():
            launches[k] += v
        if cuda and not all(got[k] for k in ("conv_block", "conv_bwd_data",
                                             "conv_bwd_w")):
            raise RuntimeError(f"[resnet50-runtime] run {tag} launched "
                               f"{got}")
        res[f"launches_{tag}"] = {k: v for k, v in got.items() if v}
        if per_steps and cuda:
            want = {k: 0 for k in dispatch.KERNELS}
            want.update(conv_block=106 * per_steps,
                        conv_bwd_data=52 * per_steps,
                        conv_bwd_w=53 * per_steps)
            if got != want:
                raise RuntimeError(f"[resnet50-runtime] run {tag}: "
                                   f"{per_steps} steps launched {got}")

    try:
        mesh = runtime_world(device, tmp)
        print(f"[resnet50-runtime] ResNet-50 {hw}x{hw}x3, batch {batch}, "
              f"f32, DistributedTrainer over a {mesh.backend} world of "
              f"{mesh.data}; A: per-step fit of {RUNTIME_STEPS} batches; "
              f"B: prefetch=2, megastep={RUNTIME_K}, validator, async "
              f"checkpoints every 2 steps, preempted after step "
              f"{RUNTIME_PREEMPT}; C: resume + batches "
              f"{RUNTIME_PREEMPT + 1}-{RUNTIME_STEPS}")
        # -- run A: the yardstick --------------------------------------
        model, tr = fresh(mesh)
        clock = StepClock()
        model.set_listeners(clock)
        sync()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        tr.fit(ListDataSetIterator(batches))
        sync()
        wall_a = time.perf_counter() - t0
        count("A", per_steps=RUNTIME_STEPS)
        if model.iteration_count != RUNTIME_STEPS:
            raise RuntimeError(f"[resnet50-runtime] A took "
                               f"{model.iteration_count} steps")
        ref = host_trees(model)
        res.update(steps_A=RUNTIME_STEPS,
                   host_ms_per_step_A=wall_a / RUNTIME_STEPS * 1e3,
                   steady_host_ms_per_step_A=(
                       (clock.steps[-1] - clock.steps[1])
                       / (len(clock.steps) - 2) * 1e3),
                   score_A=model.score_value)
        del model, tr
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        # -- run B: the whole runtime, preempted after step 4 -----------
        reg = MetricsRegistry()
        saves = []

        class TimedManager(CheckpointManager):
            """Each save's mode, step and training-thread time."""

            def save(self, model, artifacts=None, mode=None):
                t = time.perf_counter()
                out = super().save(model, artifacts=artifacts, mode=mode)
                saves.append({"mode": mode or self.mode,
                              "step": model.iteration_count,
                              "ms": (time.perf_counter() - t) * 1e3})
                return out

        mgr = TimedManager(f"{tmp}/ckpt", mode="async", keep_last=3,
                           registry=reg, device=device)

        class Notice:
            def iteration_done(self, model, iteration):
                if iteration == RUNTIME_PREEMPT:
                    handler.notify("simulated")

        model, tr = fresh(mesh)
        model.set_listeners(CheckpointListener(mgr, frequency=2), Notice())
        quarantine = QuarantineStore(f"{tmp}/quarantine", max_bytes=1 << 30)
        validator = BatchValidator(BatchSchema.from_model(model))
        wait_hist = default_registry().histogram(
            "training_prefetch_wait_ms", buckets=(0.1, 0.5, 1.0, 2.5, 5.0,
                                                  10.0, 25.0, 50.0, 100.0,
                                                  250.0, 1000.0))
        waits0 = wait_hist._default().count
        handler = PreemptionHandler(manager=mgr).install()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            tr.fit(ListDataSetIterator(poisoned), prefetch=2,
                   megastep=RUNTIME_K, validator=validator,
                   quarantine=quarantine)
            raise RuntimeError("[resnet50-runtime] B was not preempted")
        except PreemptedException as e:
            preempted = e
        finally:
            handler.uninstall()
        sync()
        wall_b = time.perf_counter() - t0
        count("B")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        ents = quarantine.entries()
        if (preempted.step != RUNTIME_PREEMPT
                or preempted.checkpoint is None
                or preempted.checkpoint.step != RUNTIME_PREEMPT
                or preempted.exit_code != 75
                or model.iteration_count != RUNTIME_PREEMPT
                or [e["reasons"] for e in ents] != [["non_finite"]]
                or ents[0]["offset"] != RUNTIME_POISON_AFTER):
            raise RuntimeError(
                f"[resnet50-runtime] B: preempted at {preempted.step} "
                f"({preempted.checkpoint}), iteration "
                f"{model.iteration_count}, quarantined {ents}")
        mgr.flush()
        write = reg.summary("checkpoint_write_ms")._default().snapshot()
        modes = [(s["mode"], s["step"]) for s in saves]
        if modes != [("async", 2), ("async", 4), ("sync", 4)]:
            raise RuntimeError(f"[resnet50-runtime] B saved {modes}")
        res.update(
            preempted_step=preempted.step, exit_code=preempted.exit_code,
            quarantined=[{k: e[k] for k in ("reasons", "offset", "size")}
                         for e in ents],
            checkpoint_steps=mgr.list_steps(),
            checkpoint_bytes=preempted.checkpoint.size,
            async_stall_ms=[s["ms"] for s in saves[:2]],
            emergency_sync_save_ms=saves[2]["ms"],
            background_write_ms=write,
            wall_B_s=wall_b, chunk_peak_bytes=peak,
            prefetch_waits=wait_hist._default().count - waits0,
            prefetch_wait_ms_p50_le=hist_quantile(wait_hist, 0.5),
            prefetch_wait_ms_p99_le=hist_quantile(wait_hist, 0.99))
        del model, tr
        if cuda:
            torch.cuda.empty_cache()

        # -- run C: resume and finish ----------------------------------
        model, tr = fresh(mesh)
        chunks = ChunkClock()
        model.set_listeners(chunks)
        sync()
        t0 = time.perf_counter()
        step = tr.resume(mgr)
        sync()
        res["restore_ms"] = (time.perf_counter() - t0) * 1e3
        if step != RUNTIME_PREEMPT:
            raise RuntimeError(f"[resnet50-runtime] C resumed at {step}")
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        tr.fit(ListDataSetIterator(batches[RUNTIME_PREEMPT:]), prefetch=2,
               megastep=RUNTIME_K)
        sync()
        wall_c = time.perf_counter() - t0
        count("C")
        if not same_as_host(torch, ref, model):
            raise RuntimeError("[resnet50-runtime] C differs from A")
        res.update(bitwise=True, steps_C=RUNTIME_STEPS - RUNTIME_PREEMPT,
                   host_ms_per_step_C=wall_c / (RUNTIME_STEPS
                                                - RUNTIME_PREEMPT) * 1e3,
                   chunks_C=len(chunks.chunks), score_C=model.score_value)
        if len(chunks.chunks) >= 2:  # the second chunk: no capture
            res["steady_host_ms_per_step_C"] = (
                (chunks.chunks[-1][0] - chunks.chunks[-2][0])
                / chunks.chunks[-1][1] * 1e3)
        if cuda:
            # the device work of a step: the captured chunk replayed (it
            # trains the model on; nothing reads it afterwards)
            graphs = list(model._megastep_graphs.values())
            if len(graphs) != 1:
                raise RuntimeError(f"[resnet50-runtime] {len(graphs)} "
                                   "captures in C, expected 1")
            chunk_ms, _ = events_ms(torch, graphs[0].graph.replay, reps=2)
            dev = chunk_ms / RUNTIME_K
            res.update(device_ms_per_step=dev,
                       busy_share_A=dev / res["steady_host_ms_per_step_A"],
                       busy_share_C=dev / res["steady_host_ms_per_step_C"])
        del model, tr
    finally:
        if handler is not None:
            handler.uninstall()
        shutdown_distributed()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[resnet50-runtime] {json.dumps(res)} card={card}")
    return launches


def run_lenet_rollback(torch, card, device="cuda", dense=None):
    """[lenet-rollback] [train]'s LeNet-5 (Adam, batch 256, synthetic
    MNIST) through ``MultiLayerNetwork.fit`` with a ``CheckpointManager``
    saving every 2 steps and ``DivergenceGuard("rollback",
    checkpoint_manager=mgr)``, minibatch 5 poisoned by a NaN: the bad
    step restores the step-4 checkpoint (bitwise the trees a listener
    copied at step 4) and training goes on; then a SKIP-guarded run with
    ``guard_lag=2`` bitwise the same run with ``guard_lag=0``. Returns
    the launch counts of the phase."""
    import shutil
    import tempfile
    import warnings

    from deeplearning4j_tpu_torch.datasets import (
        DataSet,
        MnistDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointListener,
        CheckpointManager,
    )
    from deeplearning4j_tpu_torch.resilience.guard import DivergenceGuard
    from deeplearning4j_tpu_torch.zoo import lenet

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        data = MnistDataSetIterator(LENET_TRAIN_BATCH, allow_synthetic=True,
                                    num_examples=LENET_TRAIN_BATCH
                                    * ROLLBACK_STEPS)
    batches = list(data)
    x = batches[ROLLBACK_NAN_STEP].features.copy()
    x[7, 300] = np.nan
    batches[ROLLBACK_NAN_STEP] = DataSet(x, batches[ROLLBACK_NAN_STEP].labels)
    conf = lenet() if dense is None else lenet(dense_width=dense)
    init = MultiLayerNetwork(conf, device="cpu").init().params
    tmp = tempfile.mkdtemp(prefix="dl4j_rollback_")
    seen = {}

    class AtStep4:
        """Host copies of the trees the first time step 4 completes, and
        the comparison when step 4 is reached again by the rollback."""

        def iteration_done(self, model, iteration):
            if iteration != ROLLBACK_NAN_STEP:
                return
            if "trees" not in seen:
                seen["trees"] = host_trees(model)
            else:
                seen["restored_bitwise"] = same_as_host(
                    torch, seen["trees"], model)

    try:
        mgr = CheckpointManager(tmp, keep_last=3, device=device)
        net = per_step_loop(
            MultiLayerNetwork(conf, device=device).init(params=init))
        guard = DivergenceGuard("rollback", checkpoint_manager=mgr)
        net.set_divergence_guard(guard)
        net.set_listeners(CheckpointListener(mgr, frequency=2), AtStep4())
        dispatch.reset_launch_counts()
        net.fit(batches)
        want = ROLLBACK_STEPS - 1  # the bad step is rolled back
        if (guard.rollbacks != 1 or not seen.get("restored_bitwise")
                or net.iteration_count != want
                or not np.isfinite(net.score_value)):
            raise RuntimeError(
                f"[lenet-rollback] rollbacks {guard.rollbacks}, restored "
                f"bitwise {seen.get('restored_bitwise')}, iteration "
                f"{net.iteration_count} (expected {want}), score "
                f"{net.score_value}")
        res = {"steps": ROLLBACK_STEPS, "nan_minibatch": ROLLBACK_NAN_STEP + 1,
               "rollbacks": guard.rollbacks, "restored_step": ROLLBACK_NAN_STEP,
               "restored_bitwise": True, "iteration_count": net.iteration_count,
               "checkpoints": mgr.list_steps(), "score": net.score_value}
        lagged = []
        for lag in (0, 2):
            m = per_step_loop(
                MultiLayerNetwork(conf, device=device).init(params=init))
            m.guard_lag = lag
            m.set_divergence_guard(DivergenceGuard("skip"))
            m.fit(batches)
            lagged.append(m)
        if (not same_trees(torch, *lagged) or [
                m.divergence_guard.skipped_batches for m in lagged]
                != [[ROLLBACK_NAN_STEP]] * 2):
            raise RuntimeError("[lenet-rollback] guard_lag=2 differs from "
                               "guard_lag=0")
        res.update(skip_lag2_bitwise_lag0=True,
                   skip_skipped_batches=lagged[1].divergence_guard
                   .skipped_batches)
        launches = dispatch.launch_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[lenet-rollback] {json.dumps(res)} card={card}")
    return launches


# --- the scan path: scan chunks, device-cached epochs, the fused TBPTT
# scan, and the observability around them ------------------------------

CACHED_LENET_BATCHES = 16  # one chunk at the default scan_chunk of 16
CACHED_LENET_EPOCHS = 3
CACHED_VGG_BATCHES = 8
CACHED_VGG_EPOCHS = 2
CACHED_VGG_CHUNK = 4
FUSED_CHAR_EPOCHS = 2
FUSED_CHAR_MINIBATCHES = 3  # one replay of 12 TBPTT chunks an epoch
TELEMETRY_STEPS = 8
TELEMETRY_TRACE = (3, 3)  # ProfilerListener: iterations [3, 6)


def scan_launches_ok(launches, one_step, graphs) -> bool:
    """A scan fit's launches, counted where Python runs: each captured
    chunk's warm-up step and its k captured steps (replays count none)."""
    steps = sum(1 + g.k for g in graphs)
    return launches == {k: v * steps for k, v in one_step.items()}


def cached_vs_per_step(torch, tag, make, batches, epochs, scan_chunk):
    """[lenet-cached] / [vgg16-cached]: ``fit(batches, epochs)`` of a
    list on the device-cached scan path (``scan_chunk``) against the same
    fit per step (``scan_chunk = 1``) from the same weights: the trees
    bitwise equal after the fit and after a second, timed one; the
    launches counted at capture; examples/s both ways, the device ms a
    step from the captured chunk replayed, the busy share both ways and
    the peak memory of the cached fit. Returns (launches of the phase,
    the result)."""
    from deeplearning4j_tpu_torch.ops import dispatch

    ref = per_step_loop(make(None))
    model = make({ln: {pn: t.clone() for pn, t in lp.items()}
                  for ln, lp in ref.params.items()})
    model.scan_chunk = scan_chunk
    n, rows = len(batches), int(np.shape(batches[0].features)[0])
    steps = n * epochs
    dispatch.reset_launch_counts()
    ref.fit(batches, epochs=epochs)
    torch.cuda.synchronize()
    per_step_counts = dispatch.launch_counts()
    one_step = {k: v // steps for k, v in per_step_counts.items()}
    dispatch.reset_launch_counts()
    model.fit(batches, epochs=epochs)  # the first replay captures
    torch.cuda.synchronize()
    scan_counts = dispatch.launch_counts()
    graphs = list(model._megastep_graphs.values())
    if not scan_launches_ok(scan_counts, one_step, graphs):
        raise RuntimeError(f"[{tag}] the scan fit launched {scan_counts}, "
                           f"one step {one_step}, chunks "
                           f"{[g.k for g in graphs]}")
    if not same_trees(torch, ref, model):
        raise RuntimeError(f"[{tag}] the scan fit differs from the "
                           "per-step loop")
    t0 = time.perf_counter()
    ref.fit(batches, epochs=epochs)
    torch.cuda.synchronize()
    wall_ref = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(batches, epochs=epochs)  # replays only
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not same_trees(torch, ref, model) or len(
            model._megastep_graphs) != len(graphs):
        raise RuntimeError(f"[{tag}] the timed scan fit differs")
    # the device work a step: each captured chunk replayed, over its k
    # (this trains the model on; nothing reads it afterwards)
    dev_ms = sum(events_ms(torch, g.graph.replay, reps=3)[0]
                 for g in graphs) / sum(g.k for g in graphs)
    res = {"minibatches": n, "rows": rows, "epochs": epochs,
           "scan_chunk": scan_chunk, "chunks": [g.k for g in graphs],
           "examples_per_s": steps * rows / wall,
           "per_step_examples_per_s": steps * rows / wall_ref,
           "host_ms_per_step": wall / steps * 1e3,
           "per_step_host_ms_per_step": wall_ref / steps * 1e3,
           "device_ms_per_step": dev_ms,
           "device_busy_share": dev_ms * steps / (wall * 1e3),
           "per_step_busy_share": dev_ms * steps / (wall_ref * 1e3),
           "peak_memory_mib": peak / 2 ** 20,
           "launches_per_step": {k: v for k, v in one_step.items() if v},
           "launches_counted_at_capture": {
               k: v for k, v in scan_counts.items() if v},
           "score": model.score_value, "bitwise": True}
    launches = {k: per_step_counts[k] + scan_counts[k]
                for k in per_step_counts}
    return launches, res


def run_lenet_cached(torch, card):
    """[lenet-cached] ``zoo.lenet()`` (Adam 0.01) at batch 256 on 16
    synthetic MNIST minibatches given as a list, ``fit(batches,
    epochs=3)``: the default ``scan_chunk`` of 16 makes one 16-step
    chunk, captured once and replayed 3 times with the data left on the
    card, bitwise the ``scan_chunk = 1`` fit."""
    import warnings

    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import lenet

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        batches = list(MnistDataSetIterator(
            LENET_TRAIN_BATCH, allow_synthetic=True,
            num_examples=LENET_TRAIN_BATCH * CACHED_LENET_BATCHES))

    def make(params):
        return MultiLayerNetwork(lenet(), device="cuda").init(params=params)

    print(f"[lenet-cached] LeNet-5, Adam lr 0.01, batch {LENET_TRAIN_BATCH},"
          f" {CACHED_LENET_BATCHES} minibatches x {CACHED_LENET_EPOCHS} "
          "epochs, scan_chunk 16 (device-cached) against scan_chunk 1")
    launches, res = cached_vs_per_step(
        torch, "lenet-cached", make, batches, CACHED_LENET_EPOCHS, 16)
    if res["chunks"] != [CACHED_LENET_BATCHES]:
        raise RuntimeError(f"[lenet-cached] chunks {res['chunks']}")
    print(f"[lenet-cached] {json.dumps(res)} card={card}")
    return launches


def run_vgg16_cached(torch, card):
    """[vgg16-cached] the VGG-16 ``ComputationGraph`` on synthetic
    CIFAR-10 at batch 128, 8 minibatches, ``epochs=2``, ``scan_chunk =
    4``: the graph engine's scan path (two 4-step chunks an epoch, one
    capture), bitwise the ``scan_chunk = 1`` fit."""
    import warnings

    from deeplearning4j_tpu_torch.datasets import CifarDataSetIterator
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import vgg16

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        batches = list(CifarDataSetIterator(
            VGG_BATCH, allow_synthetic=True,
            num_examples=VGG_BATCH * CACHED_VGG_BATCHES))

    def make(params):
        return ComputationGraph(vgg16(), device="cuda").init(params=params)

    print(f"[vgg16-cached] VGG-16 graph, batch {VGG_BATCH}, "
          f"{CACHED_VGG_BATCHES} minibatches x {CACHED_VGG_EPOCHS} epochs, "
          f"scan_chunk {CACHED_VGG_CHUNK} against scan_chunk 1")
    launches, res = cached_vs_per_step(
        torch, "vgg16-cached", make, batches, CACHED_VGG_EPOCHS,
        CACHED_VGG_CHUNK)
    if res["chunks"] != [CACHED_VGG_CHUNK]:
        raise RuntimeError(f"[vgg16-cached] chunks {res['chunks']}")
    print(f"[vgg16-cached] {json.dumps(res)} card={card}")
    return launches


def run_charrnn_fused(torch, card, peephole: bool, ids):
    """[charrnn-fused] the zoo char-RNN (peepholes) or its ``peephole=
    False`` twin at batch 32, 200-char segments (4 TBPTT chunks of 50)
    and 3 minibatches, ``fit(batches, epochs=2)``: the device-cached
    fused-TBPTT plan (one replay of the 3 minibatches, 12 TBPTT chunks,
    an epoch, one capture), bitwise the per-chunk loop (``scan_chunk =
    1``): parameters, RMSProp state and the carry the last minibatch
    ended with. Returns the launches of the phase."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch

    tag = "charrnn-fused" if peephole else "charrnn-seq-fused"
    conf = charrnn_conf(peephole)
    batches = char_batches(ids, CHAR_BATCH, CHAR_SEGMENT,
                           FUSED_CHAR_MINIBATCHES, seed=1)
    chunks = CHAR_SEGMENT // CHAR_TBPTT
    steps = FUSED_CHAR_MINIBATCHES * chunks * FUSED_CHAR_EPOCHS
    ref = per_step_loop(MultiLayerNetwork(conf, device="cuda").init())
    model = MultiLayerNetwork(conf, device="cuda").init(params={
        ln: {pn: t.clone() for pn, t in lp.items()}
        for ln, lp in ref.params.items()})
    print(f"[{tag}] 2 x GravesLSTM({CHAR_HIDDEN}, peephole={peephole}), "
          f"batch {CHAR_BATCH}, {FUSED_CHAR_MINIBATCHES} minibatches of "
          f"{chunks} chunks x {FUSED_CHAR_EPOCHS} epochs, device-cached "
          "fused TBPTT against the per-chunk loop")
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    ref.fit(batches, epochs=FUSED_CHAR_EPOCHS)
    torch.cuda.synchronize()
    wall_ref = time.perf_counter() - t0
    ref_counts = dispatch.launch_counts()
    one_chunk = {k: v // steps for k, v in ref_counts.items()}
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(batches, epochs=FUSED_CHAR_EPOCHS)  # captures, then replays
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t0
    counts = dispatch.launch_counts()
    graphs = list(model._megastep_graphs.values())
    groups = -(-FUSED_CHAR_MINIBATCHES // model.scan_chunk)  # one of 3
    if [g.k for g in graphs] != [
            FUSED_CHAR_MINIBATCHES // groups * chunks]:
        raise RuntimeError(f"[{tag}] chunks {[g.k for g in graphs]}")
    if not scan_launches_ok(counts, one_chunk, graphs):
        raise RuntimeError(f"[{tag}] the fused fit launched {counts}, one "
                           f"chunk {one_chunk}")
    carry_ok = all(torch.equal(model._tbptt_carry[n][k], v)
                   for n, c in ref._tbptt_carry.items()
                   for k, v in c.items())
    if not same_trees(torch, ref, model) or not carry_ok:
        raise RuntimeError(f"[{tag}] the fused fit differs from the "
                           "per-chunk loop")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(batches, epochs=FUSED_CHAR_EPOCHS)  # replays only
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    dev_ms = sum(events_ms(torch, g.graph.replay, reps=2)[0]
                 for g in graphs) / sum(g.k for g in graphs)
    res = {"minibatches": FUSED_CHAR_MINIBATCHES,
           "epochs": FUSED_CHAR_EPOCHS,
           "chunks_per_replay": sorted(g.k for g in graphs),
           "chars_per_s": steps * CHAR_BATCH * CHAR_TBPTT / wall,
           "per_chunk_loop_chars_per_s":
               steps * CHAR_BATCH * CHAR_TBPTT / wall_ref,
           "host_ms_per_chunk": wall / steps * 1e3,
           "per_chunk_loop_host_ms_per_chunk": wall_ref / steps * 1e3,
           "capture_fit_s": wall_first,
           "device_ms_per_chunk": dev_ms,
           "device_busy_share": dev_ms * steps / (wall * 1e3),
           "per_chunk_loop_busy_share": dev_ms * steps / (wall_ref * 1e3),
           "peak_memory_mib": peak / 2 ** 20,
           "launches_per_chunk": {k: v for k, v in one_chunk.items() if v},
           "launches_counted_at_capture": {
               k: v for k, v in counts.items() if v},
           "score": model.score_value, "bitwise": True, "carry_bitwise": True}
    print(f"[{tag}] {json.dumps(res)} card={card}")
    return {k: ref_counts[k] + counts[k] for k in ref_counts}


def parse_prometheus(text: str) -> dict:
    """``{sample: value}`` of a Prometheus text exposition; raises on a
    line that is neither a comment nor a sample."""
    import re

    sample = re.compile(
        r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*='
        r'"([^"\\]|\\.)*",?)*\})? (-?[0-9.e+-]+|\+Inf|-Inf|NaN)$')
    out = {}
    for line in text.splitlines():
        if line.startswith("# "):
            continue
        if not sample.match(line):
            raise RuntimeError(f"not a Prometheus sample: {line!r}")
        key, value = line.rsplit(" ", 1)
        out[key] = float(value)
    return out


class RecordList:
    """A step profiler's recorder: its records, in order."""

    def __init__(self):
        self.records = []

    def record(self, **rec):
        self.records.append(rec)


def run_telemetry(torch, card):
    """[telemetry] a LeNet-5 fit under the observability this slice
    ports: a global ``Tracer`` with a ``JsonlSink``, an active
    ``StepProfiler``, a ``TelemetryListener`` (step telemetry on), one
    ``CheckpointManager`` save and restore, once on the scan path and
    once per step (the listener's), a ``ProfilerListener`` over
    iterations [3, 6) whose trace must name the port's conv and dense
    kernels; then a LeNet ``ModelServer`` with a tracer answers a few
    requests, each one trace id across its spans, and
    ``/metrics?format=prometheus`` answers. Returns the launches."""
    import tempfile
    import urllib.request
    import warnings
    from pathlib import Path

    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.observability import (
        JsonlSink,
        MetricsRegistry,
        StepProfiler,
        TelemetryListener,
        Tracer,
        prometheus_text,
        set_active_profiler,
        set_global_tracer,
    )
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.optimize.profiler import ProfilerListener
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
    )
    from deeplearning4j_tpu_torch.serving import ModelServer
    from deeplearning4j_tpu_torch.zoo import lenet

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        batches = list(MnistDataSetIterator(
            LENET_TRAIN_BATCH, allow_synthetic=True,
            num_examples=LENET_TRAIN_BATCH * TELEMETRY_STEPS))
    tmp = Path(tempfile.mkdtemp(prefix="dl4j-telemetry-"))
    sink = JsonlSink(tmp / "trace.jsonl")
    tracer = Tracer(seed=15, sink=sink)
    registry = MetricsRegistry()
    recorder = RecordList()
    prof = StepProfiler(registry=registry, tracer=tracer, recorder=recorder)
    prev_tracer = set_global_tracer(tracer)
    prev_prof = set_active_profiler(prof)
    print(f"[telemetry] LeNet-5 at batch {LENET_TRAIN_BATCH}, "
          f"{TELEMETRY_STEPS} minibatches per step under TelemetryListener "
          "and ProfilerListener, then on the scan path; peak "
          f"{prof.peak} FLOP/s ({prof.peak_source})")
    dispatch.reset_launch_counts()
    try:
        net = MultiLayerNetwork(lenet(), device="cuda").init()
        listener = TelemetryListener(registry=registry)
        plistener = ProfilerListener(str(tmp / "prof"), *TELEMETRY_TRACE)
        net.set_listeners(listener, plistener)
        net.fit(batches)  # per step: the listeners refuse the scan
        mgr = CheckpointManager(tmp / "ckpt", device="cuda")
        mgr.save(net)
        restored, info = mgr.restore_latest()
        if not same_trees(torch, net, restored):
            raise RuntimeError("[telemetry] the restored model differs")
        net.set_listeners()
        net.fit(batches)  # the scan: one chunk, one record
        torch.cuda.synchronize()
    finally:
        set_active_profiler(prev_prof)
        set_global_tracer(prev_tracer)
        sink.close()
    launches = dispatch.launch_counts()
    recs = recorder.records
    if len(recs) != TELEMETRY_STEPS + 1 or recs[-1]["rows"] != \
            TELEMETRY_STEPS * LENET_TRAIN_BATCH:
        raise RuntimeError(f"[telemetry] {len(recs)} records, the last "
                           f"{recs[-1]}")
    worst = 0.0
    for r in recs:
        parts = (r["input_stall_ms"] + r["host_ms"] + r["dispatch_ms"]
                 + r["device_ms"])
        worst = max(worst, abs(parts - r["wall_ms"]) / r["wall_ms"])
    if worst > 0.01:
        raise RuntimeError(f"[telemetry] the split misses the wall time by "
                           f"{worst:.2%}")
    mfus = [r["mfu"] for r in recs[:-1]]
    if not all(0.0 < m <= 1.0 for m in mfus):
        raise RuntimeError(f"[telemetry] step MFU out of (0, 1]: {mfus}")
    mfu_gauge = registry.get("step_mfu")._default().value
    dev_hist = registry.get("training_device_ms")._default()
    if dev_hist.count != len(recs) or not 0.0 < mfu_gauge <= 1.0:
        raise RuntimeError(f"[telemetry] training_device_ms counted "
                           f"{dev_hist.count} of {len(recs)}, MFU "
                           f"{mfu_gauge}")
    samples = parse_prometheus(prometheus_text(registry))
    memory = {k: v for k, v in samples.items()
              if k.startswith("jax_device_memory_")}
    if len(memory) < 2 or samples.get("training_steps_total") != \
            TELEMETRY_STEPS or not samples.get("training_grad_global_norm"):
        raise RuntimeError(f"[telemetry] gauges missing: {sorted(samples)}")
    spans = tracer.finished_spans()
    names = [s.name for s in spans]
    save = next(s for s in spans if s.name == "checkpoint.save")
    restore = next(s for s in spans if s.name == "checkpoint.restore")
    if (sorted(save.attrs) != ["bytes", "prefix", "sharded", "step"]
            or restore.attrs.get("step") != info.step
            or restore.attrs.get("fallbacks") != 0
            or names.count("train.step") != len(recs)
            or "profiler.trace_ready" not in names):
        raise RuntimeError(f"[telemetry] spans {sorted(set(names))}")
    trace_doc = json.loads(Path(plistener.trace_path).read_text())
    kernel_names = {e.get("name", "") for e in trace_doc["traceEvents"]
                    if e.get("cat") == "kernel"}
    ours = sorted({k for k in ("conv_block_kernel", "conv_wide_kernel",
                               "conv_bwd_data_kernel",
                               "conv_bwd_data_resident_kernel",
                               "conv_bwd_w_kernel",
                               "conv_bwd_w_resident_kernel",
                               "matmul_block_kernel", "matmul_wide_kernel")
                   if any(k in n for n in kernel_names)})
    if not any(k.startswith("conv_") for k in ours) or not any(
            k.startswith("matmul_") for k in ours):
        raise RuntimeError(f"[telemetry] the trace names {ours} of the "
                           "port's kernels")
    lines = (tmp / "trace.jsonl").read_text().splitlines()

    # the server: one trace id a request across its spans
    stracer = Tracer(seed=16)
    server = ModelServer(net, device="cuda", tracer=stracer).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        for rows in (1, 3, 5):
            body = json.dumps({"features": np.asarray(
                batches[0].features[:rows]).tolist()}).encode()
            req = urllib.request.Request(f"{base}/predict", data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                if r.status != 200:
                    raise RuntimeError(f"[telemetry] predict {r.status}")
        with urllib.request.urlopen(f"{base}/metrics?format=prometheus",
                                    timeout=60) as r:
            served = parse_prometheus(r.read().decode())
    finally:
        server.stop()
    sspans = stracer.finished_spans()
    roots = [s for s in sspans if s.name == "serving.request"]
    per_request = [sorted({s.name for s in sspans
                           if s.trace_id == root.trace_id}) for root in roots]
    want = {"serving.request", "serving.admission", "serving.queue"}
    if len(roots) != 3 or not all(want <= set(p) for p in per_request) \
            or served.get("serving_predictions_total") != 3:
        raise RuntimeError(f"[telemetry] serving spans {per_request}, "
                           f"metrics {served}")
    torch.cuda.synchronize()
    res = {"records": len(recs), "scan_record": recs[-1],
           "per_step_record": recs[-2],
           "split_max_rel_err": worst, "step_mfu": mfu_gauge,
           "peak_flops": prof.peak,
           "memory_gauges": memory,
           "trace_jsonl_lines": len(lines),
           "span_names": sorted(set(names)),
           "trace_kernels": ours,
           "serving_spans_per_request": per_request[0],
           "prometheus_samples": len(samples)}
    print(f"[telemetry] {json.dumps(res)} card={card}")
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


def profiled_device(torch, fn):
    """``fn()`` under ``torch.profiler``: the sum of the traced device
    activities' own times (kernels, copies and memsets; ms), their
    count (each a launch, whether from the host or from a CUDA graph's
    replay), and the five largest activities by name (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, count = {}, 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        count += int(evt.count)
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(evt, attr, None)
            if v is not None:
                by_name[evt.key] = by_name.get(evt.key, 0.0) + float(v) / 1e3
                break
    total = sum(by_name.values())
    if total <= 0.0:
        raise RuntimeError("the profiler traced no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return total, count, dict(top)


def profiled_device_ms(torch, fn):
    """Device time of ``fn()`` under ``torch.profiler`` and the five
    largest activities by name (ms): ``profiled_device`` without the
    count."""
    total, _, top = profiled_device(torch, fn)
    return total, top


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
    net = per_step_loop(MultiLayerNetwork(conf, device="cuda").init())
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
        again = per_step_loop(
            MultiLayerNetwork(conf, device="cuda").init(params=init))
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
        model = per_step_loop(
            MultiLayerNetwork(conf, device="cuda").init(params=init))
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
    # device time of the fit, from the profiler, over one minibatch
    prof_batches = char_batches(ids, CHAR_BATCH, CHAR_SEGMENT, 1, seed=3)
    device_ms, top = profiled_device_ms(torch,
                                        lambda: model.fit(prof_batches))
    device_ms /= chunks
    ms_per_chunk = wall / n_chunks * 1e3
    res = {"minibatches": CHAR_MINIBATCHES, "chunks": n_chunks,
           "chars_per_s": CHAR_MINIBATCHES * CHAR_BATCH * CHAR_SEGMENT / wall,
           "host_ms_per_chunk": ms_per_chunk,
           "device_ms_per_chunk": device_ms,
           "device_busy_share": device_ms / ms_per_chunk,
           "top_device_ms_per_chunk": {k[:60]: v / chunks
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
    # at batch 1 (the conv listener's forward) every conv of AlexNet and
    # LeNet is short of WIDE_MIN_TILES: the direct tile
    "conv_block": (("alexnet.", "wide"), ("alexnet-train.", "wide"),
                   ("alexnet-b1.", "direct"), ("lenet-b1.", "direct"),
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
    # the conv listener's batch-1 forward streams w on the skinny route
    "matmul_block": (("transformer.", "wide"), ("lenet-b1.", "skinny"),
                     ("lenet", "tiled"), ("alexnet-b1.", "skinny"),
                     ("alexnet.", "tiled"), ("alexnet-train.", "tiled"),
                     ("vgg16.", "tiled"),
                     ("embedding-mlp.", "tiled"), ("semb-dp.", "tiled")),
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


def expected_counts(**counts):
    """Launch counts of every kernel: ``counts`` and zero elsewhere."""
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

    net = per_step_loop(MultiLayerNetwork(tx_conf(), device="cuda").init())
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
    want = expected_counts(flash_attention=layers * TX_STEPS,
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
    """[transformer-twin] the model at every width and TWIN_LAYERS of its
    12 layers at batch 4, t 512: two Adam steps on the card and on the CPU twin
    (the plain path), scores and every weight held."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch

    layers = TWIN_LAYERS
    net = per_step_loop(MultiLayerNetwork(tx_conf(layers),
                                          device="cuda").init())
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
    want = expected_counts(flash_attention=2 * layers, matmul_block=2,
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
    want = expected_counts(matmul_block=calls,
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
    want = expected_counts(flash_attention_streamed=layers,
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


def w2v_corpus(n_sentences=W2V_SENTENCES):
    """bench.py's Word2Vec corpus, vocabulary and id sequences (its
    first ``n_sentences`` sentences)."""
    from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor

    sentences = zipf_sentences(n_sentences, W2V_SENT_LEN, W2V_VOCAB, 0)
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


def w2v_windows(torch, sv, reps=3, fit=None):
    """``reps`` timed windows of ``W2V_REPS`` epochs of ``fit()``
    (default ``sv.fit``) after a warm epoch (s each)."""
    fit = fit or sv.fit
    sv.epochs = 1
    fit()
    torch.cuda.synchronize()
    sv.epochs = W2V_REPS
    windows = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        float(sv.lookup.syn0[0, 0])
        windows.append(time.perf_counter() - t0)
    return windows


def hold_change_l2(torch, tag, got, want, start, rel=TWIN_REL):
    """Hold what an Adam run changed, table by table, in the L2 sense:
    ``|(got - start) - (want - start)| <= rel * |want - start|``. Adam
    divides each step by the gradient's own scale, so where a gradient
    component is a sum that cancels, its last-bit noise (the same sum
    added up in another order) moves the step by up to the learning
    rate, and a few elements of a large sparse table leave any
    elementwise bound while the table agrees (``adam_past_elements``
    shows it on the moments). Returns the
    largest relative L2 difference, the largest elementwise difference
    and the count of elements past ``rel`` of the largest change (both
    reported, not held)."""
    worst, err, past = 0.0, 0.0, 0
    for g, w, s in zip(got, want, start):
        g, w, s = (t.detach().cpu().double() for t in (g, w, s))
        moved = w - s
        scale = float(moved.norm())
        if scale == 0.0:
            raise RuntimeError(f"[{tag}] the twin left a table as it was")
        diff = (g - s) - moved
        r = float(diff.norm()) / scale
        if r > rel:
            raise RuntimeError(f"[{tag}] a table's change differs from the "
                               f"twin's by {r} of its norm (> {rel})")
        worst = max(worst, r)
        err = max(err, float(diff.abs().max()))
        past += int((diff.abs() > rel * float(moved.abs().max())).sum())
    return worst, err, past


def adam_past_elements(torch, got, want, start, got_m, want_mv, t,
                       rel=TWIN_REL, decay=(0.9, 0.999)):
    """Where an Adam run's table leaves the twin's elementwise bound
    (``|(got - start) - (want - start)| > rel * max|want - start|``),
    what the moments say of the gradient there, beside all the elements
    a gradient reached (``v > 0``): the twin's gradient scale
    ``sqrt(v / (1 - b2^t))`` and the two runs' first moments' relative
    difference ``|m_got - m_want| / |m_want|`` (medians; the scale's
    largest too). A cancelling sum has a small scale and a large
    relative difference of ``m`` where the bound is left."""
    dev = want.device
    g, w, s = (torch.as_tensor(a).to(dev, torch.float64)
               for a in (got, want, start))
    moved = w - s
    past = ((g - s) - moved).abs() > rel * float(moved.abs().max())
    m_w, v_w = (a.to(torch.float64) for a in want_mv)
    m_g = torch.as_tensor(got_m).to(dev, torch.float64)
    scale = (v_w / (1.0 - decay[1] ** t)).sqrt()
    m_rel = (m_g - m_w).abs() / m_w.abs().clamp_min(1e-30)
    reached = v_w > 0

    def med(a):
        return float(a.median()) if a.numel() else None

    return {"elements": int(past.sum()),
            "grad_scale_max": (float(scale[past].max())
                               if past.any() else None),
            "grad_scale_median": med(scale[past]),
            "reached_grad_scale_median": med(scale[reached]),
            "m_rel_diff_median": med(m_rel[past]),
            "reached_m_rel_diff_median": med(m_rel[reached])}


def run_word2vec(torch, card, cache, ids):
    """[word2vec] bench.py:699's configuration exactly (200,000 words of
    a Zipf corpus over 2,000 words, D 128, W 5, K 5, B 16,384, seed 1)
    through ``Word2Vec.fit`` with on-device epoch generation, each epoch
    a CUDA-graph replay (``EpochGraph``), beside the eager route
    (``_fit_device_gen(eager=True)``) in the same run: the capture's
    seconds; words/s as the best of 3 windows of 20 epochs (2 for the
    eager route); the cold rate (a fresh trainer's corpus upload,
    capture and one epoch, best of 3); the eager epoch under
    ``torch.profiler``: the device ms of an epoch's kernels and their
    launches (the device activities traced), which both routes run, and
    each route's busy share (that device ms over its host ms an epoch);
    a replay timed with CUDA events (never profiled: see below); peak
    memory.
    Two epochs through the graph route must be bitwise two through the
    eager route from the same seed (tables and losses), two fresh
    trainers the same tables bit for bit, one epoch's draws taken on the
    card and fed to the CPU from the same tables must change the tables
    as on the card (``hold_change``), and the VP-tree nearest words
    (``TreeModelUtils``) must be the flat scan's (``FlatModelUtils``)."""
    from deeplearning4j_tpu_torch.nlp import FlatModelUtils, TreeModelUtils
    from deeplearning4j_tpu_torch.nlp import word2vec as w2v

    total_words = sum(len(s) for s in ids)
    torch.cuda.reset_peak_memory_stats()
    sv = make_w2v(cache, ids)
    if not sv._use_device_gen():
        raise RuntimeError("[word2vec] device generation is off on the card")

    def sync(v):
        torch.cuda.synchronize()
        float(v.lookup.syn0[0, 0])

    sv.fit()  # warm-up: the corpus upload and the capture
    sync(sv)
    graph = sv._dev_graph
    if graph is None or graph.graph is None:
        raise RuntimeError("[word2vec] the device route captured no graph")
    cold = []
    for _ in range(3):
        sv2 = make_w2v(cache, ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sv2.fit()
        sync(sv2)
        cold.append(time.perf_counter() - t0)
    upload = sv2._dev_upload_bytes
    capture_s = [sv2._dev_graph.capture_s, graph.capture_s]
    del sv2
    windows = w2v_windows(torch, sv)
    best = min(windows)
    # the captured epoch replayed back to back under CUDA events (this
    # trains sv on; its tables are only checked for finiteness and
    # queried afterwards): the device's time for a replay, the graph's
    # own gaps in. A replay is never run under torch.profiler: this late
    # in the script one crashed the process there (SIGSEGV in
    # CUDAGraph.replay).
    replay_ms = events_ms(torch, graph.graph.replay, reps=W2V_PROFILED)[0]
    eager = make_w2v(cache, ids)

    def eager_fit():
        eager._fit_device_gen(eager=True)

    eager_windows = w2v_windows(torch, eager, reps=2, fit=eager_fit)
    eager.epochs = W2V_PROFILED
    # the eager epoch under the profiler: its kernels' sum and launches,
    # an epoch's device work on both routes (the graph route runs the
    # same kernels: the draws from the host, the rest replayed)
    dev_ms, dev_n, top = profiled_device(torch, eager_fit)
    eager_best = min(eager_windows)
    dev_epoch_ms = dev_ms / W2V_PROFILED
    del eager
    corpus = sv.device_corpus()
    n_batches = corpus.ids.shape[0] // W2V_BATCH
    rows = W2V_BATCH * (1 + 2 * W2V_WINDOW + W2V_NEG)
    # the step's own traffic: each gathered row read, its gradient
    # written and read back, each updated row read and written
    reckoned = n_batches * 4 * rows * W2V_DIM * 4
    for t in w2v_tables(torch, sv):
        if not torch.isfinite(t).all():
            raise RuntimeError("[word2vec] a table is not finite")
    near = sv.words_nearest("w3", 10)
    if len(near) != 10 or "w3" in near:
        raise RuntimeError(f"[word2vec] words_nearest: {near}")
    flat_near = FlatModelUtils(sv).words_nearest("w3", 10)
    tree_near = TreeModelUtils(sv).words_nearest("w3", 10)
    if tree_near != flat_near:
        raise RuntimeError(f"[word2vec] nearest words: tree {tree_near}, "
                           f"flat {flat_near}, model {near}")

    # the graph route against the eager route: two epochs from the seed
    routes = []
    for eager_route in (False, True):
        r = make_w2v(cache, ids, epochs=2)
        losses = r._fit_device_gen(eager=eager_route)
        routes.append((losses.cpu(), w2v_tables(torch, r)))
    (lg, tg), (le, te) = routes
    if not torch.equal(lg, le) or not all(
            torch.equal(a, b) for a, b in zip(tg, te)):
        raise RuntimeError("[word2vec] the graph route differs from the "
                           "eager route")
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
    host_ms = best / W2V_REPS * 1e3
    eager_host_ms = eager_best / W2V_REPS * 1e3
    res = {"words": total_words, "vocab": len(cache), "dim": W2V_DIM,
           "window": W2V_WINDOW, "negative": W2V_NEG, "batch": W2V_BATCH,
           "batches_per_epoch": n_batches, "epochs_per_window": W2V_REPS,
           "route": "graph",
           "capture_s": capture_s,
           "launches_per_epoch": dev_n / W2V_PROFILED,
           "launches_per_batch": dev_n / W2V_PROFILED / n_batches,
           "replay_event_ms_per_epoch": replay_ms,
           "words_per_s": W2V_REPS * total_words / best,
           "window_s": windows,
           "cold_words_per_s": total_words / min(cold), "cold_s": cold,
           "cold_upload_bytes": upload,
           "device_ms_per_epoch": dev_epoch_ms,
           "host_ms_per_epoch": host_ms,
           "device_busy_share": dev_epoch_ms / host_ms,
           "eager_words_per_s": W2V_REPS * total_words / eager_best,
           "eager_window_s": eager_windows,
           "eager_host_ms_per_epoch": eager_host_ms,
           "eager_device_busy_share": dev_epoch_ms / eager_host_ms,
           "top_device_ms_per_epoch": {k[:60]: v / W2V_PROFILED
                                       for k, v in top.items()},
           "graph_bitwise_eager": True,
           "reckoned_bytes_per_epoch": reckoned,
           "reckoned_hbm_share": reckoned / PEAK_HBM_BYTES * 1e3
           / dev_epoch_ms,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "repeat_bitwise": True, "twin_max_abs_diff": twin_err,
           "twin_tolerance": TWIN_TOLERANCE, "twin_tightest_atol": twin_atol,
           "twin_s": time.perf_counter() - t_twin, "nearest_w3": near,
           "tree_nearest_is_flat": True}
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
    (1,000 sentences of 40 words over 1,000), D 100, window 5, 3 epochs
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
    net = per_step_loop(MultiLayerNetwork(conf, device="cuda").init())
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
    twin = per_step_loop(MultiLayerNetwork(conf, device="cpu").init(params=init))
    cpu = [float(twin.fit_minibatch(b)) for b in batches]
    np.testing.assert_allclose(scores, cpu, rtol=1e-4)
    again = per_step_loop(MultiLayerNetwork(conf, device="cuda").init(params=init))
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
        net = per_step_loop(
            MultiLayerNetwork(conf, device="cuda").init(params=init))
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


def run_nlp_periphery(torch, card, sv, cache, ids, device="cuda",
                      rows=KMEANS_ROWS):
    """[nlp-periphery] ``KMeansClustering`` on the card over ``rows`` x
    128 seeded blobs, K 64, 3 Lloyd iterations (ms an iteration): every
    row whose two nearest centers (of the CPU twin's run) lie further
    apart than the twin tolerance gets the twin's cluster, and the
    centers agree within it; ``save_static`` of ``[word2vec]``'s
    tables, read back by ``StaticWord2Vec`` bit for bit with the same
    nearest words; TF-IDF over the corpus (its sentences as documents,
    labelled by parity) on the card, equal to the CPU vectorizer's."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.clustering.kmeans import (
        _distances,
        lloyd_step,
    )
    from deeplearning4j_tpu_torch.nlp import (
        StaticWord2Vec,
        TfidfVectorizer,
        save_static,
    )

    rng = np.random.RandomState(3)
    centers = rng.randn(KMEANS_K, KMEANS_DIM).astype(np.float32) * 4.0
    x = (centers[rng.randint(0, KMEANS_K, rows)]
         + rng.randn(rows, KMEANS_DIM).astype(np.float32))
    on_card = device != "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    km = KMeansClustering.setup(KMEANS_K, KMEANS_ITERS, seed=5, device=device)
    t0 = time.perf_counter()
    c_dev, a_dev = km.fit_tensors(x)
    sync()
    km_fit_s = time.perf_counter() - t0
    xd = torch.from_numpy(x).to(device)
    if on_card:  # one Lloyd iteration's device time
        km_ms = events_ms(torch, lambda: lloyd_step(
            xd, c_dev, KMEANS_K, "euclidean"), reps=5)[0]
    else:
        t0 = time.perf_counter()
        lloyd_step(xd, c_dev, KMEANS_K, "euclidean")
        km_ms = (time.perf_counter() - t0) * 1e3
    del xd
    t_twin = time.perf_counter()
    twin = KMeansClustering.setup(KMEANS_K, KMEANS_ITERS, seed=5,
                                  device="cpu")
    c_cpu, a_cpu = twin.fit_tensors(x)
    d = _distances(torch.from_numpy(x), c_cpu, "euclidean")
    two = torch.topk(d, 2, dim=1, largest=False).values
    scale = float(d.max())
    clear = (two[:, 1] - two[:, 0]) > TWIN_REL * scale
    agree = a_dev.cpu() == a_cpu
    if not bool(agree[clear].all()):
        raise RuntimeError(f"[nlp-periphery] k-means: "
                           f"{int((~agree[clear]).sum())} clear rows differ "
                           "from the CPU twin")
    c_err = float((c_dev.cpu() - c_cpu).abs().max())
    c_scale = float(c_cpu.abs().max())
    if c_err > TWIN_REL * c_scale:
        raise RuntimeError(f"[nlp-periphery] k-means centers differ by "
                           f"{c_err} (scale {c_scale})")
    twin_s = time.perf_counter() - t_twin

    tmp = tempfile.mkdtemp(prefix="dl4j_static_")
    try:
        t0 = time.perf_counter()
        save_static(sv, tmp)
        static = StaticWord2Vec(tmp)
        same = np.array_equal(np.asarray(static.syn0),
                              sv.lookup.syn0.cpu().numpy())
        # the same ten words (a near tie may order two of them apart:
        # the store divides by the norms' product, the model's table is
        # normalized first)
        near = static.words_nearest("w3", 10)
        if not same or set(near) != set(sv.words_nearest("w3", 10)):
            raise RuntimeError(f"[nlp-periphery] StaticWord2Vec: rows "
                               f"equal {same}, nearest {near}")
        static_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    docs = [(" ".join(cache.word_at(int(i)) for i in s), f"c{n % 2}")
            for n, s in enumerate(ids)]
    t0 = time.perf_counter()
    tfidf = TfidfVectorizer(device=device)
    tfidf.fit(docs)
    ds = tfidf.vectorize_all(docs)
    sync()
    tfidf_s = time.perf_counter() - t0
    cpu_tfidf = TfidfVectorizer(device="cpu")
    cpu_tfidf.fit(docs)
    want = cpu_tfidf.vectorize_all(docs)
    if ds.features.device.type != torch.device(device).type or not torch.equal(
            ds.features.cpu(), want.features) or not torch.equal(
            ds.labels.cpu(), want.labels):
        raise RuntimeError("[nlp-periphery] TF-IDF differs from the CPU's")
    res = {"kmeans_rows": rows, "kmeans_dim": KMEANS_DIM,
           "kmeans_k": KMEANS_K, "kmeans_iterations": KMEANS_ITERS,
           "kmeans_ms_per_iteration": km_ms, "kmeans_fit_s": km_fit_s,
           "kmeans_clear_rows": int(clear.sum()),
           "kmeans_clear_rows_agree": True,
           "kmeans_center_max_abs_diff": c_err, "kmeans_twin_s": twin_s,
           "static_rows_bitwise": True, "static_s": static_s,
           "tfidf_docs": len(docs), "tfidf_vocab": len(tfidf.cache),
           "tfidf_s": tfidf_s, "tfidf_equal_cpu": True,
           "twin_tolerance": TWIN_TOLERANCE}
    print(f"[nlp-periphery] {json.dumps(res)} card={card}")


def run_nlp(torch, card):
    """The NLP / embeddings slice: ``[word2vec]`` and ``[word2vec-host]``
    on bench.py's corpus, ``[deepwalk]``, ``[glove]``,
    ``[paragraph-vectors]``, ``[embedding-mlp]``, ``[nlp-periphery]``
    (after ``[word2vec]``, on its tables), then
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
    sv = timed("word2vec", run_word2vec, cache, ids)
    timed("nlp-periphery", run_nlp_periphery, sv, cache, ids)
    del sv
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


# -- the row-sharded trainer ([semb-dp]) -------------------------------------

# One rank of [semb-dp]: forms a gloo world of two on the device, trains the
# row-sharded model on the global batches under DistributedTrainer (a
# sharded checkpoint at SEMB_SAVE_AT), writes the gathered parameters
# (rank 0), then trains ClusterWord2Vec on bench.py's corpus over the same
# world. argv[1]: a JSON spec.
_SEMB_RANK = r"""
import json, sys, time
import numpy as np
import torch
import chip_smoke as cs
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.embeddings.table import gauges
from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import dispatch
from deeplearning4j_tpu_torch.parallel import (
    ClusterWord2Vec, DistributedTrainer, build_mesh, init_distributed,
    shutdown_distributed)
from deeplearning4j_tpu_torch.resilience.checkpoint import (
    CheckpointManager, ProcessGroupCommitBarrier)
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_to_numpy, updater_state_to_numpy)

spec = json.loads(sys.argv[1])
rank, dev = spec["rank"], spec["device"]
cuda = dev != "cpu"


def sync():
    if cuda:
        torch.cuda.synchronize()


def peak():
    return torch.cuda.max_memory_allocated() if cuda else 0


init_distributed("file://" + spec["rdv"], 2, rank, device=dev,
                 backend="gloo", timeout_s=120)
mesh = build_mesh(data=2)
data = np.load(spec["data"])
conf = MultiLayerConfiguration.from_json(open(spec["conf"]).read())
t0 = time.perf_counter()
net = MultiLayerNetwork(conf, device=dev).init()
tr = DistributedTrainer(net, mesh=mesh)
sync()
out = {"setup_s": time.perf_counter() - t0, "init_peak_bytes": peak(),
       "shard_bytes": gauges()["embedding_shard_bytes"],
       "w_rows": int(net.params["0"]["W"].shape[0]),
       "moment_rows": [int(a.shape[0]) for a in net.updater_state["0"]["W"]],
       "layout": net._row_layout}
if cuda:
    torch.cuda.reset_peak_memory_stats()
mgr = CheckpointManager(spec["ckpt"], commit=ProcessGroupCommitBarrier(),
                        device=dev)
dispatch.reset_launch_counts()
ms, scores = [], []
for s in range(len(data["x"])):
    if s == spec["save_at"]:
        t0 = time.perf_counter()
        mgr.save(net)
        out["save_s"] = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    scores.append(float(tr.fit_minibatch(DataSet(data["x"][s],
                                                 data["y"][s]))))
    ms.append((time.perf_counter() - t0) * 1e3)
out["launches"] = dispatch.launch_counts()
out.update(ms_per_step=ms, scores=scores, step_peak_bytes=peak())
params, upd = core.canonical_trees(net)
if rank == 0:
    np.savez(spec["trees"], **params_to_numpy(params),
             **updater_state_to_numpy(upd))
del params, upd, net, tr
cache, ids = cs.w2v_corpus(spec["w2v_sentences"])
w2v = ClusterWord2Vec(cache, ids, mesh=mesh, layer_size=cs.W2V_DIM,
                      window=cs.W2V_WINDOW, negative=cs.W2V_NEG,
                      batch_size=cs.W2V_BATCH, epochs=cs.SEMB_W2V_EPOCHS,
                      seed=cs.W2V_SEED,
                      device=dev)
sync()
t0 = time.perf_counter()
w2v.fit()
sync()
out["w2v_s"] = time.perf_counter() - t0
if rank == 0:
    np.savez(spec["w2v"], syn0=w2v.lookup.syn0.cpu().numpy(),
             syn1neg=w2v.lookup.syn1neg.cpu().numpy())
with open(spec["out"], "w") as fh:
    json.dump(out, fh)
shutdown_distributed()
"""


def semb_conf(vocab=SEMB_VOCAB, row_sharded=True):
    """SparseEmbeddingLayer(vocab -> 128) -> Dense 256 relu -> softmax
    output over 10 classes, Adam (the embedding MLP's widths)."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (
        DenseLayer,
        OutputLayer,
        SparseEmbeddingLayer,
    )

    return (NeuralNetConfiguration.Builder().seed(12).learning_rate(1e-2)
            .updater("ADAM").list()
            .layer(SparseEmbeddingLayer(n_in=vocab, n_out=W2V_DIM,
                                        row_sharded=row_sharded))
            .layer(DenseLayer(n_in=W2V_DIM, n_out=MLP_HIDDEN,
                              activation="relu"))
            .layer(OutputLayer(n_in=MLP_HIDDEN, n_out=10))
            .build())


def semb_batches(vocab=SEMB_VOCAB, seed=0):
    """``SEMB_STEPS`` global batches of ``SEMB_BATCH`` ids drawn from a
    Zipf distribution of exponent 1.0 over ``vocab`` ids (``p ∝ 1/k``),
    labelled by the id modulo 10: ``(x [S, B, 1], y [S, B, 10])``."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    x = rng.choice(vocab, size=(SEMB_STEPS, SEMB_BATCH), p=p / p.sum())
    y = np.eye(10, dtype=np.float32)[x % 10]
    return x[..., None].astype(np.float32), y


def run_semb_dp(torch, card, device="cuda", vocab=SEMB_VOCAB,
                w2v_sentences=W2V_SENTENCES):
    """[semb-dp] the row-sharded trainer on two gloo ranks on one card (as
    ``[elastic-storm]`` forms them: NCCL refuses two ranks a device): the
    ``semb_conf`` model over ``semb_batches``, 8 steps. Each rank must
    hold half of ``W`` and of its Adam moments (``embedding_shard_bytes``
    half the table); each table's change after 8 steps must lie within
    the twin tolerance (in L2: ``hold_change_l2``) of a world of one on
    the card with ``row_sharded=False`` on the same data; a world of one
    resumed from the two ranks' step-4 checkpoint must take steps 5-8
    bitwise as a world of one resumed from the checkpoint it wrote
    itself right after that resume, and its parameters and Adam moments
    must change over steps 5-8 as the two ranks' own did (twin
    tolerance, in L2: a wrong row or moment in the width-2 save shows
    there); where the 8-step twin leaves the elementwise bound, the
    moments there are printed (``adam_past_elements``);
    ``ClusterWord2Vec`` (1 epoch of bench.py's corpus, the host-pair
    route, over the same two ranks) must change its tables as
    a single-process ``Word2Vec`` on the same batches does (twin
    tolerance; whether bitwise is printed). Prints each rank's shard
    bytes, peak memory and ms a step, and the ``matmul_block``
    launches. Returns the launches of both ranks' steps."""
    import os
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.parallel import DistributedTrainer
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
        LocalCommitBarrier,
    )

    on_card = device != "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    x, y = semb_batches(vocab)
    tmp = tempfile.mkdtemp(prefix="dl4j_semb_")
    f = os.path.join
    try:
        np.savez(f(tmp, "data.npz"), x=x, y=y)
        with open(f(tmp, "conf.json"), "w") as fh:
            fh.write(semb_conf(vocab).to_json())
        t0 = time.perf_counter()
        ranks = spawn_ranks("semb-dp", _SEMB_RANK, [dict(
            rank=r, device=device, rdv=f(tmp, "rdv"),
            data=f(tmp, "data.npz"), conf=f(tmp, "conf.json"),
            ckpt=f(tmp, "ck2"), save_at=SEMB_SAVE_AT,
            trees=f(tmp, "trees.npz"), w2v=f(tmp, "w2v.npz"),
            w2v_sentences=w2v_sentences, out=f(tmp, f"rank{r}.json"))
            for r in range(2)], SEMB_TIMEOUT_S, tmp)
        ranks_s = time.perf_counter() - t0
        if any(rc != 0 for rc, _ in ranks):
            raise RuntimeError("[semb-dp] a rank failed:\n" + "\n---\n".join(
                f"exit {rc}: {err}" for rc, err in ranks))
        outs = []
        for r in range(2):
            with open(f(tmp, f"rank{r}.json")) as fh:
                outs.append(json.load(fh))
        half = vocab // 2 * W2V_DIM * 4
        for r, o in enumerate(outs):
            if (o["shard_bytes"] != half or o["w_rows"] != vocab // 2
                    or o["moment_rows"] != [vocab // 2] * 2
                    or o["layout"] != {"shards": 2, "rank": r,
                                       "layers": ["0"]}):
                raise RuntimeError(f"[semb-dp] rank {r} holds {o}")
        launches = {k: sum(o["launches"].get(k, 0) for o in outs)
                    for k in dispatch.KERNELS}
        want = {k: 0 for k in dispatch.KERNELS}
        if on_card:
            want["matmul_block"] = 2 * SEMB_STEPS
        if launches != want:
            raise RuntimeError(f"[semb-dp] the ranks launched {launches}")
        if outs[0]["scores"] != outs[1]["scores"]:
            raise RuntimeError("[semb-dp] the ranks' scores differ")

        # the world of one, replicated, on the same data
        t_twin = time.perf_counter()
        batches = [DataSet(x[s], y[s]) for s in range(SEMB_STEPS)]
        twin = MultiLayerNetwork(semb_conf(vocab, row_sharded=False),
                                 device=device).init()
        start = {f"{ln}/{pn}": t.detach().cpu().clone()
                 for ln, lp in twin.params.items() for pn, t in lp.items()}
        tr = DistributedTrainer(twin)
        twin_ms = []
        for b in batches:
            sync()
            t0 = time.perf_counter()
            tr.fit_minibatch(b)
            sync()
            twin_ms.append((time.perf_counter() - t0) * 1e3)
        # the two ranks' step-8 parameters ("layer/param") and updater
        # state ("layer/param/i"), gathered
        got = dict(np.load(f(tmp, "trees.npz")))
        keys = sorted(start)
        rel_l2, err, past = hold_change_l2(
            torch, "semb-dp", [torch.from_numpy(got[k]) for k in keys],
            [twin.params[k.split("/")[0]][k.split("/")[1]] for k in keys],
            [start[k] for k in keys])
        past_w = adam_past_elements(
            torch, got["0/W"], twin.params["0"]["W"], start["0/W"],
            got["0/W/0"], twin.updater_state["0"]["W"], SEMB_STEPS)
        del twin, tr, start
        twin_s = time.perf_counter() - t_twin

        # the cross-width resume: A from the ranks' checkpoint, B from
        # the one A writes right after its resume
        def world_of_one(source, save_to=None):
            net = MultiLayerNetwork(semb_conf(vocab), device=device).init()
            trainer = DistributedTrainer(net)
            step = trainer.resume(CheckpointManager(source, device=device))
            if step != SEMB_SAVE_AT:
                raise RuntimeError(f"[semb-dp] resumed at step {step}")
            resumed = trees_of(net)
            if save_to is not None:
                CheckpointManager(save_to, commit=LocalCommitBarrier(),
                                  device=device).save(net)
            for b in batches[SEMB_SAVE_AT:]:
                trainer.fit_minibatch(b)
            return net, resumed

        def trees_of(net):
            return {**{f"{ln}/{pn}": t.detach().cpu().clone()
                       for ln, lp in net.params.items()
                       for pn, t in lp.items()},
                    **{f"{ln}/{pn}/{i}": a.detach().cpu().clone()
                       for ln, lp in net.updater_state.items()
                       for pn, tup in lp.items()
                       for i, a in enumerate(tup)}}

        t_resume = time.perf_counter()
        a, a_start = world_of_one(f(tmp, "ck2"), save_to=f(tmp, "ck1"))
        b, _ = world_of_one(f(tmp, "ck1"))
        if not same_trees(torch, a, b):
            raise RuntimeError("[semb-dp] a world of one resumed from the "
                               "two ranks' checkpoint differs from one "
                               "resumed from its own")
        del b
        # A's steps 5-8 against the two ranks' own steps 5-8, parameters
        # and Adam's moments: the width-2 save carried each rank's rows
        # and moments where a width-1 restore finds them
        a_end = trees_of(a)
        rkeys = sorted(a_end)
        if sorted(got) != rkeys:
            raise RuntimeError(f"[semb-dp] the ranks wrote {sorted(got)}, "
                               f"a world of one holds {rkeys}")
        resume_rel_l2, resume_err, resume_past = hold_change_l2(
            torch, "semb-dp resume", [torch.from_numpy(got[k])
                                      for k in rkeys],
            [a_end[k] for k in rkeys], [a_start[k] for k in rkeys])
        del a, a_end, a_start, got
        resume_s = time.perf_counter() - t_resume

        # ClusterWord2Vec against one process on the same batches
        t_w2v = time.perf_counter()
        cache, ids = w2v_corpus(w2v_sentences)
        single = make_w2v(cache, ids, device=device,
                          epochs=SEMB_W2V_EPOCHS)
        single.device_epoch_gen = False
        w_start = w2v_tables(torch, single)
        single.fit()
        mine = dict(np.load(f(tmp, "w2v.npz")))
        w_got = [torch.from_numpy(mine["syn0"]),
                 torch.from_numpy(mine["syn1neg"])]
        w_want = w2v_tables(torch, single)
        w_err, w_atol = hold_change(torch, "semb-dp cluster-word2vec",
                                    w_got, w_want, w_start)
        w_bitwise = all(torch.equal(g, w) for g, w in zip(w_got, w_want))
        w2v_twin_s = time.perf_counter() - t_w2v
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"vocab": vocab, "dim": W2V_DIM, "batch": SEMB_BATCH,
           "steps": SEMB_STEPS, "ranks": 2, "backend": "gloo",
           "table_bytes": vocab * W2V_DIM * 4,
           "embedding_shard_bytes": [o["shard_bytes"] for o in outs],
           "init_peak_memory_gb": [o["init_peak_bytes"] / 1e9 for o in outs],
           "step_peak_memory_gb": [o["step_peak_bytes"] / 1e9 for o in outs],
           "ms_per_step": [o["ms_per_step"] for o in outs],
           "mean_ms_per_step": [float(np.mean(o["ms_per_step"][1:]))
                                for o in outs],
           "world_of_one_ms_per_step": twin_ms,
           "scores": outs[0]["scores"], "setup_s": [o["setup_s"]
                                                    for o in outs],
           "save_s": [o.get("save_s") for o in outs], "ranks_s": ranks_s,
           "twin_s": twin_s, "resume_s": resume_s,
           "cluster_word2vec_twin_s": w2v_twin_s,
           "twin_rel_l2": rel_l2, "twin_max_abs_diff": err,
           "twin_elements_past_elementwise": past,
           "twin_w_past_elements": past_w,
           "twin_tolerance": f"each table's change within {TWIN_REL:g} of "
                             "the twin's, in L2",
           "resume_width1_bitwise_own_checkpoint": True,
           "resume_vs_ranks_rel_l2": resume_rel_l2,
           "resume_vs_ranks_max_abs_diff": resume_err,
           "resume_vs_ranks_elements_past_elementwise": resume_past,
           "cluster_word2vec_s": [o["w2v_s"] for o in outs],
           "cluster_word2vec_max_abs_diff": w_err,
           "cluster_word2vec_tightest_atol": w_atol,
           "cluster_word2vec_bitwise": w_bitwise,
           "launches": {k: v for k, v in launches.items() if v}}
    print(f"[semb-dp] {json.dumps(res)} card={card}")
    return launches


# -- the elastic control plane and the default fit (main paths) -----------

ELASTIC_STEPS = 8          # runs A and B; C stops the coordinator after
ELASTIC_SNAPSHOT = 4       # HostElasticTrainer(snapshot_every=4)
ELASTIC_COORD_STOP = 5     # ... step 5
ELASTIC_LEASE_S = 5.0
STORM_BATCHES = 12         # LeNet-5, global batch 256
STORM_SNAPSHOT = 4
STORM_KILL = 7             # KillAtStep(7) on rank 1
STORM_LEASE_S = 1.0
STORM_TIMEOUT_S = 300
DEFAULT_FIT_BATCHES = 4    # one chunk at the engines' scan_chunk of 16


class TimedCalls:
    """Wraps ``obj.name`` to note each call's host ms (and its result)."""

    def __init__(self, obj, name):
        self.ms, self.results = [], []
        inner = getattr(obj, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.results.append(out)
            return out
        setattr(obj, name, timed)


def tree_bytes(tree) -> int:
    """The bytes of every tensor of ``{a: {b: tensor or tuple}}``."""
    return sum(t.numel() * t.element_size() for lp in tree.values()
               for v in lp.values()
               for t in (v if isinstance(v, tuple) else (v,)))


def run_elastic_resnet50(torch, card, device="cuda", conf=None,
                         batch=RESNET_BATCH, hw=224):
    """[elastic-resnet50] ResNet-50 at 224 x 224, batch 128, f32 (the
    zoo's ``ComputationGraph``, NESTEROVS), on an NCCL world of one
    formed over the rendezvous a real ``LeaseCoordinator(1)`` grants
    (TCP, in this process) to this process's ``WorkerAgent``; three
    runs from the same seeded weights and batches: A, the yardstick,
    ``DistributedTrainer.fit_minibatch`` over 8 batches; B,
    ``HostElasticTrainer(snapshot_every=4)`` over them (a coordinator
    barrier at every step, lockstep snapshots at steps 0 and 4): its
    trees and iteration count bitwise A's, the barrier's round trip, the
    snapshot push (ms, bytes), host ms a step and the busy share beside
    A's (the device ms of the trainer's step, one profiled step); C, the
    same with the coordinator stopped after step 5: the agent's retries
    exhaust within its policy's bound, the trainer saves through a
    ``CheckpointManager`` and raises
    ``PreemptedException(step=5, reason="coordinator-lost")``, exit code
    75; a fresh model resumes the checkpoint and fits steps 6-8 bitwise
    A's. Returns the launch counts of the runs. ``device`` / ``conf`` /
    ``batch`` / ``hw`` cut it for a rehearsal on the CPU."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.parallel import (
        DistributedTrainer,
        HostElasticTrainer,
        LeaseCoordinator,
        WorkerAgent,
        build_mesh,
        init_distributed_elastic,
        shutdown_distributed,
    )
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
    )
    from deeplearning4j_tpu_torch.resilience.preemption import (
        PreemptedException,
    )
    from deeplearning4j_tpu_torch.zoo import resnet50

    cuda = device == "cuda"
    conf = conf if conf is not None else resnet50(learning_rate=0.01)
    rng = np.random.RandomState(29)
    batches = [DataSet(rng.randint(0, 256, (batch, 3, hw, hw),
                                   dtype=np.uint8),
                       np.eye(1000, dtype=np.uint8)[rng.randint(0, 1000,
                                                                batch)])
               for _ in range(ELASTIC_STEPS)]
    init = ComputationGraph(conf, device="cpu").init().params
    tmp = tempfile.mkdtemp(prefix="dl4j_elastic_")
    launches = {k: 0 for k in dispatch.KERNELS}
    res = {"batch": batch, "hw": hw, "world": 1,
           "snapshot_every": ELASTIC_SNAPSHOT}
    coord = agent = None

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def fresh():
        return per_step_loop(
            ComputationGraph(conf, device=device).init(params=init))

    def count(tag, steps):
        got = dispatch.launch_counts()
        for k, v in got.items():
            launches[k] += v
        res[f"launches_{tag}"] = {k: v for k, v in got.items() if v}
        if cuda:
            want = {k: 0 for k in dispatch.KERNELS}
            want.update(conv_block=106 * steps, conv_bwd_data=52 * steps,
                        conv_bwd_w=53 * steps)
            if got != want:
                raise RuntimeError(f"[elastic-resnet50] run {tag}: {steps} "
                                   f"steps launched {got}")

    def timed_run(fn):
        """``fn()`` on the host clock, synchronised: seconds."""
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t0

    try:
        coord = LeaseCoordinator(1, lease_s=ELASTIC_LEASE_S,
                                 registry=MetricsRegistry()).start()
        agent = WorkerAgent(coord.address, rank_hint=0,
                            registry=MetricsRegistry())
        grant = agent.join(timeout_s=60)
        agent.start_renewals()
        init_distributed_elastic(grant.rendezvous, grant.num, grant.rank,
                                 device=device, timeout_s=60)
        mesh = build_mesh()
        if cuda and mesh.backend != "nccl":
            raise RuntimeError(f"[elastic-resnet50] formed {mesh.backend}")
        print(f"[elastic-resnet50] ResNet-50 {hw}x{hw}x3, batch {batch}, "
              f"f32, a {mesh.backend} world of {mesh.data} over the lease "
              f"coordinator's rendezvous {grant.rendezvous} (epoch "
              f"{grant.epoch}); A: DistributedTrainer, {ELASTIC_STEPS} steps;"
              f" B: HostElasticTrainer(snapshot_every={ELASTIC_SNAPSHOT}); "
              f"C: the coordinator stopped after step {ELASTIC_COORD_STOP}, "
              "then a resume")

        # -- run A: the yardstick --------------------------------------
        model = fresh()
        tr = DistributedTrainer(model, mesh=mesh, batch_stats="sync")
        dispatch.reset_launch_counts()
        wall = timed_run(lambda: [tr.fit_minibatch(ds) for ds in batches])
        count("A", ELASTIC_STEPS)
        ref = host_trees(model)
        res.update(host_ms_per_step_A=wall / ELASTIC_STEPS * 1e3,
                   score_A=model.score_value)
        dev = None
        if cuda:
            # the device work of the trainer's step: the profiler's sum
            # over one more step (the profiler slows the host ~10x, so
            # the timed runs go without it; A's trees are kept above)
            dev, _ = profiled_device_ms(
                torch, lambda: tr.fit_minibatch(batches[0]))
            res.update(device_ms_per_step=dev,
                       busy_share_A=dev * ELASTIC_STEPS / (wall * 1e3))
        del model, tr

        # -- run B: HostElasticTrainer, a barrier every step -----------
        model = fresh()
        reg = MetricsRegistry()
        tr = HostElasticTrainer(model, agent, mesh=mesh,
                                snapshot_every=ELASTIC_SNAPSHOT,
                                registry=reg, batch_stats="sync")
        barriers = TimedCalls(agent, "step_barrier")
        pushes = TimedCalls(tr.ring, "push")
        dispatch.reset_launch_counts()
        wall = timed_run(lambda: tr.fit(batches))
        del agent.step_barrier  # the agent's own method again
        count("B", ELASTIC_STEPS)
        if (model.iteration_count != ELASTIC_STEPS
                or not same_as_host(torch, ref, model)):
            raise RuntimeError("[elastic-resnet50] B differs from A")
        if (any(p is not None for p in barriers.results)
                or len(barriers.ms) != ELASTIC_STEPS
                or len(pushes.ms) != 2 or tr.recoveries):
            raise RuntimeError(
                f"[elastic-resnet50] B: barriers {barriers.results}, "
                f"{len(pushes.ms)} snapshots, {tr.recoveries} recoveries")
        snap = tr.ring.latest()
        res.update(
            bitwise_B=True,
            barrier_ms_p50=float(np.percentile(barriers.ms, 50)),
            barrier_ms_max=max(barriers.ms),
            snapshot_push_ms=pushes.ms,
            snapshot_bytes=sum(tree_bytes(snap[k]) for k in (
                "params", "updater_state", "state")),
            host_ms_per_step_B=wall / ELASTIC_STEPS * 1e3,
            score_B=model.score_value)
        if dev is not None:  # B's step is A's, the pushes beside it
            res["busy_share_B"] = dev * ELASTIC_STEPS / (wall * 1e3)
        del model, tr, snap
        if cuda:
            torch.cuda.empty_cache()

        # -- run C: the coordinator lost after step 5 ------------------
        saves = []

        class TimedManager(CheckpointManager):
            def save(self, model, artifacts=None, mode=None):
                t = time.perf_counter()
                out = super().save(model, artifacts=artifacts, mode=mode)
                saves.append({"t0": t, "step": model.iteration_count,
                              "ms": (time.perf_counter() - t) * 1e3})
                return out

        mgr = TimedManager(f"{tmp}/ckpt", keep_last=2, device=device)
        model = fresh()
        tr = HostElasticTrainer(model, agent, mesh=mesh,
                                snapshot_every=ELASTIC_SNAPSHOT,
                                checkpoint_manager=mgr,
                                registry=MetricsRegistry(),
                                batch_stats="sync")
        stopped = []

        class StopCoordinator:
            def iteration_done(self, model, iteration):
                if iteration == ELASTIC_COORD_STOP and not stopped:
                    coord.stop()
                    stopped.append(time.perf_counter())

        model.set_listeners(StopCoordinator())
        dispatch.reset_launch_counts()
        try:
            tr.fit(batches)
            raise RuntimeError("[elastic-resnet50] C was not preempted")
        except PreemptedException as e:
            t_exc = time.perf_counter()
            lost = e
        sync()
        count("C", ELASTIC_COORD_STOP)
        bound_s = agent.policy.total_timeout
        exhausted_s = saves[0]["t0"] - stopped[0] if saves else None
        if (lost.step != ELASTIC_COORD_STOP
                or lost.reason != "coordinator-lost"
                or lost.exit_code != 75 or lost.checkpoint is None
                or lost.checkpoint.step != ELASTIC_COORD_STOP
                or [s["step"] for s in saves] != [ELASTIC_COORD_STOP]
                or model.iteration_count != ELASTIC_COORD_STOP
                or exhausted_s is None or exhausted_s > bound_s):
            raise RuntimeError(
                f"[elastic-resnet50] C: {lost!r} at step {lost.step} "
                f"({lost.reason}, exit {lost.exit_code}), saves {saves}, "
                f"retries exhausted after {exhausted_s} s (bound {bound_s})")
        res.update(preempted_step=lost.step, reason=lost.reason,
                   exit_code=lost.exit_code,
                   retries_exhausted_s=exhausted_s, retry_bound_s=bound_s,
                   stop_to_exception_s=t_exc - stopped[0],
                   save_ms=saves[0]["ms"],
                   checkpoint_bytes=lost.checkpoint.size)
        agent.close()
        del model, tr
        if cuda:
            torch.cuda.empty_cache()

        # ... then a fresh model resumes the checkpoint: steps 6-8
        model = fresh()
        tr = DistributedTrainer(model, mesh=mesh, batch_stats="sync")
        sync()
        t0 = time.perf_counter()
        step = tr.resume(mgr)
        sync()
        res["restore_ms"] = (time.perf_counter() - t0) * 1e3
        if step != ELASTIC_COORD_STOP:
            raise RuntimeError(f"[elastic-resnet50] resumed at {step}")
        dispatch.reset_launch_counts()
        for ds in batches[ELASTIC_COORD_STOP:]:
            tr.fit_minibatch(ds)
        sync()
        count("resume", ELASTIC_STEPS - ELASTIC_COORD_STOP)
        if not same_as_host(torch, ref, model):
            raise RuntimeError("[elastic-resnet50] the resumed run differs "
                               "from A")
        res.update(bitwise_resumed=True, score_resumed=model.score_value)
        del model, tr
    finally:
        if agent is not None:
            agent.close()
        if coord is not None:
            coord.stop()
        shutdown_distributed()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[elastic-resnet50] {json.dumps(res)} card={card}")
    return launches


# One rank of [elastic-storm]: joins the lease coordinator, forms the
# world over its rendezvous, trains LeNet-5 under HostElasticTrainer;
# rank 1 notes the time and SIGKILLs itself after step 7. argv[1]: a
# JSON spec.
_STORM_RANK = r"""
import json, sys, time
import numpy as np
import torch
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability.metrics import default_registry
from deeplearning4j_tpu_torch.ops import dispatch
from deeplearning4j_tpu_torch.parallel import (
    HostElasticTrainer, WorkerAgent, build_mesh, init_distributed_elastic,
    shutdown_distributed)
from deeplearning4j_tpu_torch.resilience.chaos import KillAtStep
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy, params_to_numpy, updater_state_to_numpy)
from deeplearning4j_tpu_torch.zoo import lenet

spec = json.loads(sys.argv[1])
rank, dev = spec["rank"], spec["device"]
data = np.load(spec["data"])
batches = [DataSet(data[f"x{i}"], data[f"y{i}"])
           for i in range(len(data.files) // 2)]
agent = WorkerAgent(spec["control"], rank_hint=rank)
grant = agent.join(timeout_s=120)
agent.start_renewals()  # before the bring-up: keep renewing
init_distributed_elastic(grant.rendezvous, grant.num, grant.rank,
                         device=dev, backend="gloo", timeout_s=120)
net = MultiLayerNetwork(lenet(), device=dev).init(
    params=params_from_numpy(dict(np.load(spec["init"])), dev))
tr = HostElasticTrainer(net, agent, mesh=build_mesh(data=grant.num),
                        snapshot_every=spec["snap_every"],
                        reform_timeout_s=120)
steps, plans = [], []


class Clock:
    def iteration_done(self, model, it):
        if dev != "cpu":
            torch.cuda.synchronize()
        steps.append((int(it), time.time()))
        if it == spec["kill_at"]:
            with open(spec["kill_note"], "w") as f:
                f.write(repr(time.time()))


barrier = agent.step_barrier


def noted(step, timeout_s=None):
    plan = barrier(step, timeout_s)
    if plan is not None:
        plans.append(time.time())
    return plan


agent.step_barrier = noted
net.listeners.append(Clock())
if spec["kill_at"] >= 0:
    net.listeners.append(KillAtStep(spec["kill_at"]))
dispatch.reset_launch_counts()
tr.fit(batches, epochs=1)
if dev != "cpu":
    torch.cuda.synchronize()
launches = dispatch.launch_counts()
rec_ms = default_registry().get("host_recovery_ms")._default().snapshot()
snap = tr.last_recovery_snapshot
torch.save(snap, spec["snapshot"])
out = {"p:" + k: v for k, v in params_to_numpy(net.params).items()}
out.update({"u:" + k: v for k, v in
            updater_state_to_numpy(tr.trainer.gather_updater_state()).items()})
np.savez(spec["trees"], **out)
with open(spec["out"], "w") as f:
    json.dump({"iteration": int(net.iteration_count),
               "recoveries": tr.recoveries, "last_recovery": tr.last_recovery,
               "epoch": agent.epoch, "world": tr.mesh.data,
               "backend": tr.mesh.backend, "steps": steps, "plans": plans,
               "recovery_ms": rec_ms, "launches": launches}, f)
agent.close()
shutdown_distributed()
"""

# The piecewise reference of [elastic-storm]: the recovery snapshot
# replayed at survivor width (a gloo world of one on the same device).
_STORM_REFERENCE = r"""
import json, sys
import numpy as np
import torch
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.parallel import (
    DistributedTrainer, SnapshotRing, build_mesh, init_distributed,
    shutdown_distributed)
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_to_numpy, updater_state_to_numpy)
from deeplearning4j_tpu_torch.zoo import lenet

spec = json.loads(sys.argv[1])
dev = spec["device"]
data = np.load(spec["data"])
batches = [DataSet(data[f"x{i}"], data[f"y{i}"])
           for i in range(len(data.files) // 2)]
snap = torch.load(spec["snapshot"], weights_only=False)
net = MultiLayerNetwork(lenet(), device=dev).init()
ring = SnapshotRing(registry=MetricsRegistry())
ring._ring.append(snap)
ring.restore_into_model(net)
init_distributed("file://" + spec["rdv"], 1, 0, device=dev, backend="gloo",
                 timeout_s=120)
tr = DistributedTrainer(net, mesh=build_mesh(data=1))
for ds in batches[snap["epoch_index"]:]:
    tr.fit_minibatch(ds)
out = {"p:" + k: v for k, v in params_to_numpy(net.params).items()}
out.update({"u:" + k: v for k, v in
            updater_state_to_numpy(tr.gather_updater_state()).items()})
out["iteration"] = np.asarray(net.iteration_count)
np.savez(spec["trees"], **out)
shutdown_distributed()
"""


def spawn_ranks(tag, script, specs, timeout_s, logdir):
    """``script`` in one process a spec (``PYTHONPATH`` this checkout,
    stderr to ``<logdir>/<tag>-<i>.err``, a crash's Python stacks
    included: ``-X faulthandler``); every process is waited for,
    or killed once ``timeout_s`` has passed. Returns their (return
    code, stderr tail)."""
    import os
    import pathlib

    root = str(pathlib.Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="4")
    procs, logs = [], []
    for i, spec in enumerate(specs):
        logs.append(os.path.join(logdir, f"{tag}-{i}.err"))
        with open(logs[-1], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-X", "faulthandler", "-c", script,
                 json.dumps(spec)], cwd=root,
                env=env, stdout=subprocess.DEVNULL, stderr=err))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"[{tag}] a process ran past "
                                   f"{timeout_s} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for p, log in zip(procs, logs):
        with open(log) as fh:
            out.append((p.returncode, fh.read()[-3000:]))
    return out


def run_elastic_storm(torch, card, device="cuda"):
    """[elastic-storm] LeNet-5 at full width (the zoo's, Adam) on
    synthetic MNIST, global batch 256, 12 minibatches, under
    ``HostElasticTrainer(snapshot_every=4)`` in two rank processes on
    the card: a ``LeaseCoordinator(2, lease_s=1)`` in this process, the
    world a gloo group over CUDA tensors (``backend="gloo"`` named:
    NCCL refuses two ranks on one card), ``KillAtStep(7)`` SIGKILLs
    rank 1. Rank 0 must exit 0 and rank 1 by SIGKILL; rank 0 recovers
    once, rolled back to step 4 (within one snapshot window of the
    kill), takes 12 steps, and its parameters and updater state are
    bitwise a piecewise reference: a process that restores the recovery
    snapshot and replays at survivor width on the card. Prints the time
    from the kill to the plan, the recovery ms, the steps lost and the
    survivor's examples/s before and after the loss. Returns rank 0's
    launch counts."""
    import os
    import shutil
    import tempfile
    import warnings

    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.parallel import LeaseCoordinator
    from deeplearning4j_tpu_torch.util.model_serializer import (
    params_to_numpy, updater_state_to_numpy)
    from deeplearning4j_tpu_torch.zoo import lenet

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        batches = list(MnistDataSetIterator(
            LENET_TRAIN_BATCH, allow_synthetic=True,
            num_examples=LENET_TRAIN_BATCH * STORM_BATCHES))
    tmp = tempfile.mkdtemp(prefix="dl4j_storm_")
    f = os.path.join
    np.savez(f(tmp, "data.npz"),
             **{f"x{i}": np.asarray(b.features)
                for i, b in enumerate(batches)},
             **{f"y{i}": np.asarray(b.labels)
                for i, b in enumerate(batches)})
    np.savez(f(tmp, "init.npz"), **params_to_numpy(
        MultiLayerNetwork(lenet(), device="cpu").init().params))
    common = {"device": device, "data": f(tmp, "data.npz")}
    print(f"[elastic-storm] LeNet-5 full width, Adam, global batch "
          f"{LENET_TRAIN_BATCH}, {STORM_BATCHES} minibatches, "
          f"HostElasticTrainer(snapshot_every={STORM_SNAPSHOT}) on 2 rank "
          f"processes over a gloo group on {device}, lease {STORM_LEASE_S} "
          f"s, KillAtStep({STORM_KILL}) on rank 1")
    coord = LeaseCoordinator(2, lease_s=STORM_LEASE_S,
                             barrier_timeout_s=60.0,
                             registry=MetricsRegistry()).start()
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks("elastic-storm", _STORM_RANK, [dict(
            common, rank=r, control=coord.address, init=f(tmp, "init.npz"),
            snap_every=STORM_SNAPSHOT,
            kill_at=STORM_KILL if r == 1 else -1,
            kill_note=f(tmp, f"kill{r}.txt"), out=f(tmp, f"rank{r}.json"),
            trees=f(tmp, f"trees{r}.npz"),
            snapshot=f(tmp, f"snapshot{r}.pt")) for r in range(2)],
            STORM_TIMEOUT_S, tmp)
        wall = time.perf_counter() - t0
    finally:
        coord.stop()
    try:
        (rc0, err0), (rc1, err1) = ranks
        if rc1 != -9 or rc0 != 0:
            raise RuntimeError(f"[elastic-storm] rank 0 exit {rc0}, rank 1 "
                               f"exit {rc1} (want 0, -9):\n{err0}\n---\n"
                               f"{err1}")
        with open(f(tmp, "rank0.json")) as fh:
            surv = json.load(fh)
        with open(f(tmp, "kill1.txt")) as fh:
            killed = float(fh.read())
        rec = surv["last_recovery"]
        if (surv["recoveries"] != 1 or surv["iteration"] != STORM_BATCHES
                or rec["dead"] != [1] or rec["survivors"] != 1
                or rec["rolled_back_to"] != STORM_SNAPSHOT
                or not STORM_KILL - STORM_SNAPSHOT <= rec["rolled_back_to"]
                <= STORM_KILL or surv["world"] != 1
                or surv["backend"] != "gloo" or len(surv["plans"]) != 1):
            raise RuntimeError(f"[elastic-storm] survivor: {surv}")
        ref = spawn_ranks("elastic-storm-ref", _STORM_REFERENCE, [dict(
            common, snapshot=f(tmp, "snapshot0.pt"), rdv=f(tmp, "ref_rdv"),
            trees=f(tmp, "ref.npz"))], STORM_TIMEOUT_S, tmp)
        if ref[0][0] != 0:
            raise RuntimeError(f"[elastic-storm] reference: {ref[0][1]}")
        got, want = (dict(np.load(f(tmp, "trees0.npz"))),
                     dict(np.load(f(tmp, "ref.npz"))))
        if int(want.pop("iteration")) != surv["iteration"] or (
                got.keys() != want.keys()) or not all(
                np.array_equal(got[k], want[k]) for k in want):
            raise RuntimeError("[elastic-storm] the survivor differs from "
                               "the piecewise reference")
        plan_t = surv["plans"][0]
        steps = surv["steps"]
        before = [t for it, t in steps if t < plan_t]
        after = [t for it, t in steps if t > plan_t]

        def rate(ts):
            return (LENET_TRAIN_BATCH * (len(ts) - 1) / (ts[-1] - ts[0])
                    if len(ts) >= 2 else None)

        launches = {k: surv["launches"].get(k, 0) for k in dispatch.KERNELS}
        one_step = {"conv_block": 4, "conv_bwd_data": 1, "conv_bwd_w": 2,
                    "matmul_block": 1}
        taken = len(steps)  # rank 0's steps, the replayed ones included
        if device == "cuda" and launches != {
                k: one_step.get(k, 0) * taken for k in dispatch.KERNELS}:
            raise RuntimeError(f"[elastic-storm] {taken} steps launched "
                               f"{launches}")
        res = {"ranks": 2, "exit_codes": [rc0, rc1], "recoveries": 1,
               "rolled_back_to": rec["rolled_back_to"],
               "killed_after_step": STORM_KILL,
               "steps_lost": STORM_KILL - rec["rolled_back_to"],
               "steps_taken": taken, "iteration": surv["iteration"],
               "kill_to_plan_s": plan_t - killed,
               "recovery_ms": surv["recovery_ms"],
               "examples_per_s_before": rate(before),
               "examples_per_s_after": rate(after),
               "storm_wall_s": wall, "bitwise": True,
               "launches": {k: v for k, v in launches.items() if v}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[elastic-storm] {json.dumps(res)} card={card}")
    return launches


def default_vs_per_step(torch, tag, make, batches):
    """[default-fit] ``fit(batches)`` of a list at the engine's default
    ``scan_chunk`` (16: one chunk of the list's minibatches, one CUDA-graph
    capture) against the same fit at ``scan_chunk = 1`` from the same
    weights: the trees bitwise equal (parameters, updater and layer
    state) after the first fit of each and again after a second, timed
    one (the scan fit's second replays only); the launches counted at
    capture; the device ms a step from CUDA events around the timed
    fit's replay, the busy share both ways, the peak memory of the
    capturing fit and of the replaying one, and the capture's host
    seconds. Returns (launches of the phase, the result)."""
    from deeplearning4j_tpu_torch.nn import core
    from deeplearning4j_tpu_torch.ops import dispatch

    ref = per_step_loop(make(None))
    model = make({ln: {pn: t.clone() for pn, t in lp.items()}
                  for ln, lp in ref.params.items()})
    if model.scan_chunk != 16:
        raise RuntimeError(f"[{tag}] default scan_chunk {model.scan_chunk}")
    n, rows = len(batches), int(np.shape(batches[0].features)[0])
    dispatch.reset_launch_counts()
    ref.fit(batches)
    torch.cuda.synchronize()
    per_step_counts = dispatch.launch_counts()
    one_step = {k: v // n for k, v in per_step_counts.items()}
    captures, replays = [], []
    capture, replay = core.GraphedChunk.capture, core.GraphedChunk.replay

    def timed_capture(self, m):
        t = time.perf_counter()
        capture(self, m)
        captures.append(time.perf_counter() - t)

    def timed_replay(self, trees):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = replay(self, trees)
        end.record()
        replays.append((start, end))
        return out

    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    core.GraphedChunk.capture = timed_capture
    try:
        t0 = time.perf_counter()
        model.fit(batches)  # captures, then replays
        torch.cuda.synchronize()
        wall_first = time.perf_counter() - t0
    finally:
        core.GraphedChunk.capture = capture
    peak_first = torch.cuda.max_memory_allocated()
    scan_counts = dispatch.launch_counts()
    graphs = list(model._megastep_graphs.values())
    if [g.k for g in graphs] != [n] or len(captures) != 1:
        raise RuntimeError(f"[{tag}] chunks {[g.k for g in graphs]}, "
                           f"{len(captures)} captures")
    if not scan_launches_ok(scan_counts, one_step, graphs):
        raise RuntimeError(f"[{tag}] the scan fit launched {scan_counts}, "
                           f"one step {one_step}")
    if not same_trees(torch, ref, model):
        raise RuntimeError(f"[{tag}] the default fit differs from its "
                           "scan_chunk = 1 fit")
    # the second fits, timed: the per-step loop, then the scan path's
    # replay of the captured chunk (its device time on the events)
    t0 = time.perf_counter()
    ref.fit(batches)
    torch.cuda.synchronize()
    wall_ref = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    core.GraphedChunk.replay = timed_replay
    try:
        t0 = time.perf_counter()
        model.fit(batches)  # replays only
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        core.GraphedChunk.replay = replay
    peak = torch.cuda.max_memory_allocated()
    if len(model._megastep_graphs) != 1 or len(replays) != 1:
        raise RuntimeError(f"[{tag}] the second fit captured again or "
                           f"replayed {len(replays)} times")
    if not same_trees(torch, ref, model):
        raise RuntimeError(f"[{tag}] the second default fit differs")
    dev_ms = replays[0][0].elapsed_time(replays[0][1]) / n
    res = {"minibatches": n, "rows": rows, "scan_chunk": model.scan_chunk,
           "chunks": [g.k for g in graphs], "bitwise": True,
           "examples_per_s": n * rows / wall,
           "per_step_examples_per_s": n * rows / wall_ref,
           "host_ms_per_step": wall / n * 1e3,
           "per_step_host_ms_per_step": wall_ref / n * 1e3,
           "device_ms_per_step": dev_ms,
           "device_busy_share": dev_ms * n / (wall * 1e3),
           "per_step_busy_share": dev_ms * n / (wall_ref * 1e3),
           "capture_s": captures[0], "capture_fit_s": wall_first,
           "peak_memory_capture_mib": peak_first / 2 ** 20,
           "peak_memory_replay_mib": peak / 2 ** 20,
           "launches_per_step": {k: v for k, v in one_step.items() if v},
           "launches_counted_at_capture": {
               k: v for k, v in scan_counts.items() if v},
           "score": model.score_value}
    del ref, model, graphs
    torch.cuda.empty_cache()
    return {k: per_step_counts[k] + scan_counts[k]
            for k in per_step_counts}, res


def run_default_fit(torch, card, tokens):
    """[default-fit] the default ``fit`` (``scan_chunk`` 16) of the large
    models, each over 4 minibatches against its ``scan_chunk = 1`` fit
    (``default_vs_per_step``): ResNet-50 (batch 128, 224 x 224, f32,
    NESTEROVS), the transformer LM of bench.py:866 (d 768, 12 layers, 16
    x 512, Adam, f32) and AlexNet (batch 128, NESTEROVS, dropout 0.5 on
    both dense layers: the masks' keys derived inside the replay).
    Returns the launch counts of the three."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import alexnet, resnet50

    n = DEFAULT_FIT_BATCHES
    launches = {}
    rn_conf, ax_conf = resnet50(learning_rate=0.01), alexnet()
    models = (
        ("resnet50", lambda p: ComputationGraph(rn_conf, device="cuda")
         .init(params=p), lambda: resnet_batches(n, RESNET_BATCH, seed=31)),
        ("transformer", lambda p: MultiLayerNetwork(tx_conf(), device="cuda")
         .init(params=p), lambda: char_batches(
             tokens, TX_BATCH, TX_T, n, seed=37, vocab=TX["vocab"])),
        ("alexnet", lambda p: MultiLayerNetwork(ax_conf, device="cuda")
         .init(params=p), lambda: standardized(
             resnet_batches(n, ALEXNET_TRAIN_BATCH, seed=41))))
    print(f"[default-fit] the default fit (scan_chunk 16) of ResNet-50 "
          f"(batch {RESNET_BATCH}), the transformer LM ({TX_BATCH} x "
          f"{TX_T}) and AlexNet with dropout (batch {ALEXNET_TRAIN_BATCH}),"
          f" {n} minibatches each, against scan_chunk 1")
    for tag, make, data in models:
        t0 = time.perf_counter()
        got, res = default_vs_per_step(torch, f"default-fit {tag}", make,
                                       data())
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        res["phase_s"] = time.perf_counter() - t0
        print(f"[default-fit] {tag} {json.dumps(res)} card={card}")
    return launches


# -- the serving tier: a fleet of tenants and the AOT restart ------------------

FLEET_CLIENTS = 12
FLEET_REQUESTS = 12        # a client; tenants drawn from FLEET_MIX
FLEET_AFTER_RELOAD = 3     # a client's requests after the VGG-16 reload
FLEET_MIX = (("lenet", 0.4), (None, 0.35), ("resnet50", 0.25))
FLEET_OVERLOAD = 160       # in-process submits at once (bound 16 + 64)
RETRY_LO = 0.05            # the server's RETRY_AFTER_MIN
FLEET_ROUTER_CLIENTS = 6
FLEET_ROUTER_REQUESTS = 8
VGG_IMAGE = (3, 32, 32)
RESNET_IMAGE = (3, 224, 224)
# the fleet transform waits on this while the overload check holds the
# drain thread (set: no wait)
FLEET_GATE = threading.Event()
FLEET_GATE.set()


def fleet_transform(feats):
    """The fleet's request transform: flat rows of VGG-16's CIFAR width
    become [n, 3, 32, 32], ResNet-50's uint8 pixels become [n, 3, 224,
    224] standardized as ``[resnet50]``'s twin steps feed them ((p -
    127.5) / 73.9), LeNet-5's 784-wide rows pass as they are; a LeNet-5
    row starting with -1 is a poisoned request (the breaker's trip)."""
    FLEET_GATE.wait(timeout=120)
    feats = np.asarray(feats, np.float32)
    width = feats.shape[-1]
    if width == int(np.prod(VGG_IMAGE)):
        return feats.reshape((-1,) + VGG_IMAGE)
    if width == int(np.prod(RESNET_IMAGE)):
        return ((feats - 127.5) / 73.9).reshape((-1,) + RESNET_IMAGE)
    if feats.reshape(-1, width)[0, 0] == -1.0:
        raise ValueError("poisoned request")
    return feats


def fleet_rows(tenant, rng):
    """One request's rows for ``tenant`` (None: the default, VGG-16)."""
    if tenant == "lenet":
        return rng.rand(int(rng.randint(1, 5)), 784).astype(np.float32)
    if tenant is None:
        return rng.rand(int(rng.randint(1, 5)),
                        int(np.prod(VGG_IMAGE))).astype(np.float32)
    return rng.randint(0, 256, (int(rng.randint(1, 3)),
                                int(np.prod(RESNET_IMAGE))), dtype=np.uint8)


def post_json(port, body, path="/predict"):
    """(status, JSON body, headers, seconds) of one POST."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = json.loads(resp.read())
        return resp.status, out, dict(resp.getheaders()), \
            time.perf_counter() - t0
    finally:
        conn.close()


def check_answers(tag, records, twins):
    """Every 200 answer against its twin's ``output`` (CPU, plain
    path) on the same rows, to kernel_tols (rtol 2e-4, atol 2e-5).
    ``records``: (tenant, version, rows, output); ``twins``: {(tenant,
    version): CPU model}. Returns the largest absolute error."""
    worst = 0.0
    for key, twin in twins.items():
        mine = [r for r in records if (r[0], r[1]) == key]
        if not mine:
            continue
        x = fleet_transform(np.concatenate([r[2] for r in mine]))
        ref = twin.output(x)
        ref = (ref[0] if isinstance(ref, list) else ref).numpy()
        got = np.concatenate([r[3] for r in mine])
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5,
                                   err_msg=f"[{tag}] {key}")
        worst = max(worst, float(np.abs(got - ref).max()))
    return worst


def quantiles_ms(values):
    return {"p50_ms": float(np.quantile(values, 0.5)) * 1e3,
            "p99_ms": float(np.quantile(values, 0.99)) * 1e3}


def run_fleet(torch, card, device="cuda", confs=None):
    """[fleet] one ``ModelServer`` over three f32 tenants on the card,
    ``max_device_models=2``: VGG-16 (``zoo.vgg16``, 32 x 32 CIFAR width)
    as the default tenant restored from a ``CheckpointManager``, LeNet-5
    and ResNet-50 at 224 x 224 (``zoo.resnet50``), random weights from
    seeds. A ResNet-50 evict -> fault-in answers bitwise as before;
    seeded concurrent traffic over all three through HTTP with one hot
    reload of VGG-16 (step 2 of the manager) in the middle: every answer
    against its version's CPU twin, zero 5xx, the shape counters flat
    across the paging; an overload (128 LeNet-5 answers, then the drain
    held) shed with the adaptive Retry-After, queue depth over the
    drain rate; the breaker
    opened by poisoned requests (503 circuit_open, half-open, closed);
    then a ``ServingRouter`` over this server and a second
    one (copies of the same weights): the rendezvous owners, and zero
    lost requests when one server stops mid-load. Returns the launch
    counts of the traffic. ``confs`` ({"lenet", "vgg16", "vgg16b",
    "resnet50"}) and ``device="cpu"`` rehearse it at a small size."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.resilience.breaker import CircuitBreaker
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
    )
    from deeplearning4j_tpu_torch.serving import ModelServer, ServingRouter
    from deeplearning4j_tpu_torch.zoo import lenet, resnet50, vgg16

    tmp = tempfile.mkdtemp(prefix="dl4j_fleet_")
    servers = []
    router = None
    try:
        confs = confs or {"lenet": lenet(), "resnet50": resnet50(),
                          "vgg16": vgg16(), "vgg16b": vgg16(seed=43)}
        lenet_m = MultiLayerNetwork(confs["lenet"], device=device).init()
        resnet_m = ComputationGraph(confs["resnet50"], device=device).init()
        vgg_a = ComputationGraph(confs["vgg16"], device=device).init()
        vgg_b = ComputationGraph(confs["vgg16b"], device=device).init()
        mgr = CheckpointManager(f"{tmp}/vgg16", device=device)
        vgg_a.iteration_count = 1
        mgr.save(vgg_a)
        twins = {("lenet", 1): cpu_twin(torch, lenet_m),
                 ("resnet50", 1): cpu_twin(torch, resnet_m),
                 (None, 1): cpu_twin(torch, vgg_a),
                 (None, 2): cpu_twin(torch, vgg_b)}
        sizes = {"lenet": lenet_m.num_params(),
                 "resnet50": resnet_m.num_params(),
                 "vgg16": vgg_a.num_params()}
        breaker = CircuitBreaker(failure_threshold=3, reset_timeout=0.5,
                                 name="predict")
        t0 = time.perf_counter()
        server = ModelServer(
            checkpoint_manager=mgr, device=device, transform=fleet_transform,
            models={"lenet": lenet_m, "resnet50": resnet_m},
            max_device_models=2, workers=16, queue_depth=64,
            breaker=breaker, retry_after=5.0, max_batch_size=32,
            batch_timeout_ms=2.0)
        servers.append(server)
        server.start()
        start_s = time.perf_counter() - t0
        entry = server.model_registry.entry
        print(f"[fleet] ModelServer over VGG-16 (default, {sizes['vgg16']} "
              f"params, step 1 of a CheckpointManager), LeNet-5 "
              f"({sizes['lenet']}) and ResNet-50 224x224 ({sizes['resnet50']}"
              f"), f32, max_device_models=2, buckets "
              f"{server.batcher.ladder.buckets}: started in {start_s:.2f} s")
        vgg_b.iteration_count = 2
        mgr.save(vgg_b)  # the reload's target: step 2

        # ResNet-50's bucket-32 forward on the device clock (resident
        # after start: the warm-up's LRU victim is VGG-16), and LeNet-5's
        # solo latency with nothing else in flight
        rng0 = np.random.RandomState(3)
        if entry("resnet50").resident != "device":
            raise RuntimeError("[fleet] ResNet-50 is not resident at start")
        x32 = torch.from_numpy(fleet_transform(
            rng0.randint(0, 256, (32, int(np.prod(RESNET_IMAGE)))))
        ).to(device)
        resnet_b32_ms = (graph_ms(torch, lambda: resnet_m.output(x32))
                         if device == "cuda" else None)
        solo_s = [post_json(server.port, {
            "features": fleet_rows("lenet", rng0)[:1].tolist(),
            "model": "lenet"})[3] for _ in range(16)]

        # a ResNet-50 evict -> fault-in: the same kernels on the same
        # operands, so the answers are bitwise those before the eviction
        rng = np.random.RandomState(5)
        probe = fleet_rows("resnet50", rng)[:1].repeat(2, axis=0)
        probe[1] = rng.randint(0, 256, probe.shape[1])
        code, before, _ = server.submit(probe, model="resnet50")
        for other in (None, "lenet"):
            code2, _, _ = server.submit(fleet_rows(other, rng), model=other)
            if code2 != 200:
                raise RuntimeError(f"[fleet] warm request answered {code2}")
        if code != 200 or entry("resnet50").resident != "host":
            raise RuntimeError("[fleet] ResNet-50 was not evicted")
        paged_before = server.model_registry.stats()
        t1 = time.perf_counter()
        code, after, _ = server.submit(probe, model="resnet50")
        fault_ms = (time.perf_counter() - t1) * 1e3
        if code != 200 or after["output"] != before["output"]:
            raise RuntimeError("[fleet] ResNet-50's answers after the "
                               "fault-in differ from those before")
        paged = server.model_registry.stats()

        # seeded concurrent traffic over the three tenants, with the
        # VGG-16 reload in the middle
        snap0 = server.metrics_snapshot()["counters"]
        dispatch.reset_launch_counts()
        records, lat = [], {}
        lock = threading.Lock()
        halfway, reloaded = threading.Event(), threading.Event()
        names = [t for t, _ in FLEET_MIX]
        probs = [p for _, p in FLEET_MIX]

        def client(i):
            # FLEET_REQUESTS requests, and at least FLEET_AFTER_RELOAD
            # of them sent after the reload has swapped
            crng = np.random.RandomState(100 + i)
            n = after = 0
            while n < FLEET_REQUESTS or after < FLEET_AFTER_RELOAD:
                swapped = reloaded.is_set()
                n += 1
                after += swapped
                tenant = names[int(crng.choice(len(names), p=probs))]
                x = fleet_rows(tenant, crng)
                body = {"features": x.tolist()}
                if tenant is not None:
                    body["model"] = tenant
                code, out, _, dt = post_json(server.port, body)
                with lock:
                    records.append((tenant, out.get("model_version"), x,
                                    np.asarray(out.get("output"), np.float32)
                                    if code == 200 else None, code))
                    lat.setdefault(tenant, []).append(dt)
                    if len(records) >= FLEET_CLIENTS * FLEET_REQUESTS // 3:
                        halfway.set()

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(FLEET_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        if not halfway.wait(timeout=300):
            raise RuntimeError("[fleet] the traffic stalled")
        code, reload_body = server.reload({})
        reloaded.set()
        if code != 200 or reload_body["version"] != 2:
            raise RuntimeError(f"[fleet] reload answered {code}: "
                               f"{reload_body}")
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                raise RuntimeError("[fleet] a client did not finish")
        wall = time.perf_counter() - t0
        codes = [r[4] for r in records]
        if set(codes) != {200}:
            raise RuntimeError(f"[fleet] non-200 answers under traffic: "
                               f"{sorted(set(codes))}")
        versions = sorted({r[1] for r in records if r[0] is None})
        if versions != [1, 2]:
            raise RuntimeError(f"[fleet] VGG-16 answered from versions "
                               f"{versions}, not both")
        # overload: the drain thread held in the transform, more
        # in-process submits at once than the bound (16 + 64): the
        # excess sheds with Retry-After = queue depth / drain rate
        shed, ok = [], [0]

        def burst(i):
            x = fleet_rows("resnet50", np.random.RandomState(900 + i))
            code, body, headers = server.submit(x, model="resnet50")
            with lock:
                if code == 503:
                    shed.append((body["error"]["retry_after"],
                                 int(headers["Retry-After"])))
                elif code == 200:
                    ok[0] += 1

        def lenet_client(i):  # the recent drain: 128 LeNet-5 answers
            prng = np.random.RandomState(700 + i)
            for _ in range(8):
                server.submit(fleet_rows("lenet", prng), model="lenet")

        primers = [threading.Thread(target=lenet_client, args=(i,))
                   for i in range(16)]
        for t in primers:
            t.start()
        for t in primers:
            t.join(timeout=300)
        bound = server.workers + server.queue_depth
        FLEET_GATE.clear()
        bursts = [threading.Thread(target=burst, args=(i,))
                  for i in range(FLEET_OVERLOAD)]
        try:
            for t in bursts:
                t.start()
            for _ in range(3000):
                with lock:
                    if len(shed) >= FLEET_OVERLOAD - bound:
                        break
                time.sleep(0.01)
            # nothing completes while the drain is held: the queue and
            # the drain rate stand still, so every shed saw this value
            held_queue = server._queue.qsize()
            held_rate = server.metrics.drain_rate()
            expect = server.retry_after_value()
        finally:
            FLEET_GATE.set()
        for t in bursts:
            t.join(timeout=600)
        retry = [s[0] for s in shed]
        if (ok[0] != bound or len(shed) != FLEET_OVERLOAD - bound
                or not RETRY_LO <= expect < server.retry_after
                or any(r != round(expect, 3) for r in retry)
                or any(h != max(1, int(np.ceil(expect))) for _, h in shed)):
            raise RuntimeError(f"[fleet] overload: {ok[0]} ok, "
                               f"{len(shed)} shed, retry_after {shed[:8]}, "
                               f"queue {held_queue}, rate {held_rate}")

        snap1 = server.metrics_snapshot()
        c1 = snap1["counters"]
        n_vgg_buckets = len(server.batcher.ladder.buckets)
        if (c1["post_warmup_compiles_total"] != 0
                or c1["xla_compiles_total"]
                != snap0["xla_compiles_total"] + n_vgg_buckets):
            raise RuntimeError(f"[fleet] the shape counters moved under "
                               f"paging: {snap0} -> {c1}")
        err = check_answers("fleet", [r for r in records], twins)

        # the breaker: poisoned requests trip it, a good one closes it
        poison = np.full((1, 784), -1.0, np.float32)
        for _ in range(3):
            code, _, _, _ = post_json(server.port, {
                "features": poison.tolist(), "model": "lenet"})
            if code != 500:
                raise RuntimeError(f"[fleet] a poisoned request got {code}")
        code, open_body, open_headers, _ = post_json(server.port, {
            "features": fleet_rows("lenet", rng).tolist(), "model": "lenet"})
        ready_code, ready = server.readiness()
        if (code != 503 or open_body["error"]["status"] != "circuit_open"
                or "breaker_open" not in ready.get("reasons", [])):
            raise RuntimeError(f"[fleet] the open breaker answered {code} "
                               f"{open_body}, readiness {ready}")
        time.sleep(0.6)
        code, _, _, _ = post_json(server.port, {
            "features": fleet_rows("lenet", rng).tolist(), "model": "lenet"})
        if code != 200 or breaker.state != "closed":
            raise RuntimeError(f"[fleet] the breaker did not close: {code}, "
                               f"{breaker.state}")

        # a router over this server and a second one: copies of the
        # same weights (VGG-16 at version 2, as this server serves now)
        second = ModelServer(
            vgg_b.copy(), device=device, transform=fleet_transform,
            models={"lenet": lenet_m.copy(), "resnet50": resnet_m.copy()},
            max_device_models=2, workers=16, queue_depth=64,
            max_batch_size=32, batch_timeout_ms=2.0).start()
        servers.append(second)
        router = ServingRouter([f"127.0.0.1:{s.port}" for s in servers],
                               health_interval=0.1).start()
        owners = {str(n): router.candidates(n or "")[0].address
                  for n in ("", "lenet", "resnet50")}
        victim_port = router.candidates("lenet")[0].port
        victim = next(s for s in servers if s.port == victim_port)
        routed = []
        third = threading.Event()

        def router_client(i):
            crng = np.random.RandomState(500 + i)
            for _ in range(FLEET_ROUTER_REQUESTS):
                tenant = names[int(crng.choice(len(names),
                                               p=(0.5, 0.35, 0.15)))]
                x = fleet_rows(tenant, crng)
                body = {"features": x.tolist()}
                if tenant is not None:
                    body["model"] = tenant
                code, out, _, _ = post_json(router.port, body)
                with lock:
                    routed.append((tenant, 2 if tenant is None else 1, x,
                                   np.asarray(out.get("output"), np.float32)
                                   if code == 200 else None, code))
                    if len(routed) >= (FLEET_ROUTER_CLIENTS
                                       * FLEET_ROUTER_REQUESTS // 3):
                        third.set()

        rthreads = [threading.Thread(target=router_client, args=(i,))
                    for i in range(FLEET_ROUTER_CLIENTS)]
        for t in rthreads:
            t.start()
        if not third.wait(timeout=300):
            raise RuntimeError("[fleet] the routed traffic stalled")
        victim.stop(drain_timeout=10.0)
        for t in rthreads:
            t.join(timeout=600)
            if t.is_alive():
                raise RuntimeError("[fleet] a routed client did not finish")
        launches = dispatch.launch_counts()
        lost = sum(1 for r in routed if r[4] != 200)
        if lost:
            raise RuntimeError(f"[fleet] {lost} routed requests lost")
        err = max(err, check_answers("fleet-router", routed, twins))
        for k in ("conv_block", "matmul_block"):
            if device == "cuda" and launches[k] <= 0:
                raise RuntimeError(f"[fleet] the traffic launched no {k}")
        rsnap = router.metrics_snapshot()
        per_tenant = {str(t or "vgg16"): {
            **quantiles_ms(v), "requests": len(v)} for t, v in lat.items()}
        res = {
            "requests": len(records), "requests_per_s": len(records) / wall,
            "resnet50_bucket32_device_ms": resnet_b32_ms,
            "lenet_solo_p50_ms": float(np.median(solo_s)) * 1e3,
            "per_tenant": per_tenant,
            "max_abs_err_vs_twin": err,
            "resnet50_fault_in_request_ms": fault_ms,
            "pagein_ms_max_at_probe": paged["weight_pagein_ms"]["max"],
            "pageout_ms_max_at_probe": paged["weight_pageout_ms"]["max"],
            "bytes": {t: entry(t).nbytes
                      for t in server.model_registry.names()},
            "pagein_ms": snap1["paging"]["weight_pagein_ms"],
            "pageout_ms": snap1["paging"]["weight_pageout_ms"],
            "bytes_paged_in": snap1["paging"]["bytes_paged_in"],
            "bytes_paged_out": snap1["paging"]["bytes_paged_out"],
            "pageins": snap1["paging"]["weight_pagein_total"],
            "evictions": snap1["paging"]["weight_evict_total"],
            "pageins_before_probe": paged_before["weight_pagein_total"],
            "xla_compiles_total": c1["xla_compiles_total"],
            "post_warmup_compiles_total": c1["post_warmup_compiles_total"],
            "reload_ms": reload_body["reload_ms"],
            "breaker_rejected_total": server.metrics.get(
                "breaker_rejected_total"),
            "overload": {"ok": ok[0], "shed": len(shed),
                         "retry_after_s": expect,
                         "retry_after_header": shed[0][1],
                         "queue": held_queue, "drain_rate_per_s": held_rate,
                         "cap_s": server.retry_after},
            "router": {"owners": owners, "victim": victim_port,
                       "requests": len(routed), "lost": lost,
                       "retries": rsnap["router_retries_total"],
                       "forwarded": {b["address"]: b["forwarded"]
                                     for b in rsnap["backends"]}},
            "launches": launches,
        }
        print(f"[fleet] {json.dumps(res)} card={card}")
        return launches
    finally:
        if router is not None:
            router.stop()
        for s in servers:
            if not s._draining:
                s.stop()
        shutil.rmtree(tmp, ignore_errors=True)


_AOT_CHILD = r"""
import json, sys, time
t_spawn, work, device = float(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np
import chip_smoke as cs
cs.RESNET_IMAGE = tuple(json.loads(sys.argv[4]))  # the parent's
from deeplearning4j_tpu_torch.compile.persistent import cache_stats
from deeplearning4j_tpu_torch.ops import _build, dispatch
from deeplearning4j_tpu_torch.resilience.checkpoint import CheckpointManager
from deeplearning4j_tpu_torch.serving import ModelServer

import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
probes = dict(np.load(work + "/probes.npz"))
servers, out, res = [], {}, {"servers": {}}
res["imports_s"] = time.time() - t_spawn
for tag in ("lenet", "resnet50", "lenet-corrupt"):
    t0 = time.time()
    mgr = CheckpointManager(f"{work}/{tag}", device=device)
    s = ModelServer(checkpoint_manager=mgr, device=device, aot=True,
                    transform=cs.fleet_transform)
    t1 = time.time()
    s.start()
    servers.append(s)
    if tag == "resnet50":
        res["boot_to_ready_s"] = time.time() - t_spawn
    x = probes[tag.split("-")[0]]
    code, body, _ = s.submit(x)
    assert code == 200, body
    out[tag] = np.asarray(body["output"], np.float32)
    reg = s.metrics.registry
    res["servers"][tag] = {
        "aot_buckets": s._aot_buckets,
        "aot_fallback_total": reg.get("aot_fallback_total").value,
        "xla_compiles_total": s.metrics.get("xla_compiles_total"),
        "compile_cache_hits_total": reg.get(
            "compile_cache_hits_total").value,
        "compile_cache_misses_total": reg.get(
            "compile_cache_misses_total").value,
        "restore_s": t1 - t0, "start_s": time.time() - t1}
res["build_seconds"] = _build.build_seconds
res["loaded_path"] = str(_build.loaded_path)
res["cache_stats"] = cache_stats()
res["launches"] = dispatch.launch_counts()
for s in servers:
    s.stop()
np.savez(work + "/child.npz", **{k.replace("-", "_"): v
                                 for k, v in out.items()})
print("[aot-child] " + json.dumps(res))
"""


def run_aot_restart(torch, card, build_s, device="cuda", confs=None):
    """[aot-restart] LeNet-5 and ResNet-50 (224 x 224, f32) saved through
    ``CheckpointManager``s with a serving bundle (the built kernel
    library and one shape record a bucket); a fresh process with
    ``DL4J_TPU_COMPILE_CACHE_DIR`` set to an empty temporary directory
    starts ``ModelServer(aot=True)`` on each: zero nvcc builds
    (``build_seconds`` None, ``compile_cache_misses_total`` 0), no first
    forward counted at warm-up, and answers bitwise this process's on the
    same padded bucket. Then a third server on a checkpoint whose
    bucket-2 record is corrupt: ``aot_fallback_total`` 1, the answers
    still bitwise. Returns the child's launch counts. ``confs``
    ({"lenet", "resnet50"}) and ``device="cpu"`` rehearse it at a small
    size (no library is loaded there)."""
    import os
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.compile.aot import export_serving_bundle
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
    )
    from deeplearning4j_tpu_torch.serving import BucketLadder, pad_rows
    from deeplearning4j_tpu_torch.zoo import lenet, resnet50

    work = tempfile.mkdtemp(prefix="dl4j_aot_")
    cache = tempfile.mkdtemp(prefix="dl4j_kcache_")
    try:
        rng = np.random.RandomState(17)
        buckets = BucketLadder(None, 32).buckets
        confs = confs or {"lenet": lenet(), "resnet50": resnet50()}
        width = int(np.prod(RESNET_IMAGE))
        models = {"lenet": (MultiLayerNetwork(confs["lenet"],
                                              device=device).init(),
                            rng.rand(4, 784).astype(np.float32), (784,)),
                  "resnet50": (ComputationGraph(confs["resnet50"],
                                                device=device).init(),
                               rng.randint(0, 256, (2, width))
                               .astype(np.float32), RESNET_IMAGE)}
        want, t0 = {}, time.perf_counter()
        for tag, (net, x, feature) in models.items():
            bundle = export_serving_bundle(net, buckets,
                                           feature_shape=feature)
            CheckpointManager(f"{work}/{tag}", device=device).save(
                net, artifacts=bundle)
            if tag == "lenet":
                bad = dict(bundle, **{"aot-output-b2": bundle[
                    "aot-output-b2"][:20]})
                CheckpointManager(f"{work}/lenet-corrupt",
                                  device=device).save(net, artifacts=bad)
            feats = fleet_transform(x)
            bucket = next(b for b in buckets if b >= len(x))
            out = net.output_padded(pad_rows(feats, bucket), n_valid=len(x))
            want[tag] = (out[0] if isinstance(out, list) else out
                         ).float().cpu().numpy()
        save_s = time.perf_counter() - t0
        np.savez(f"{work}/probes.npz", lenet=models["lenet"][1],
                 resnet50=models["resnet50"][1])
        env = dict(os.environ, DL4J_TPU_COMPILE_CACHE_DIR=cache,
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        t_spawn = time.time()
        proc = subprocess.run(
            [sys.executable, "-c", _AOT_CHILD, repr(t_spawn), work, device,
             json.dumps(RESNET_IMAGE)],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            capture_output=True, text=True, timeout=600)
        child_s = time.time() - t_spawn
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("[aot-child] ")), None)
        if proc.returncode != 0 or line is None:
            raise RuntimeError(f"[aot-restart] the restarted process "
                               f"failed ({proc.returncode}):\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        res = json.loads(line[len("[aot-child] "):])
        got = dict(np.load(f"{work}/child.npz"))
        for tag, key in (("lenet", "lenet"), ("resnet50", "resnet50"),
                         ("lenet-corrupt", "lenet_corrupt")):
            if not np.array_equal(got[key], want[tag.split("-")[0]]):
                raise RuntimeError(f"[aot-restart] {tag}'s answers differ "
                                   "from this process's")
        srv = res["servers"]
        loaded = device != "cuda" or (
            res["loaded_path"].startswith(cache)
            and srv["lenet"]["compile_cache_hits_total"] == 1)
        if (res["build_seconds"] is not None
                or res["cache_stats"]["misses"] != 0
                or any(s["compile_cache_misses_total"] for s in srv.values())
                or not loaded or not os.path.exists(
                    os.path.join(cache, _build.library_name()))):
            raise RuntimeError(f"[aot-restart] the restart built kernels: "
                               f"{res}")
        if (srv["lenet"]["aot_buckets"] != len(buckets)
                or srv["resnet50"]["aot_buckets"] != len(buckets)
                or srv["lenet"]["xla_compiles_total"] != 0
                or srv["resnet50"]["xla_compiles_total"] != 0
                or srv["lenet"]["aot_fallback_total"] != 0):
            raise RuntimeError(f"[aot-restart] the bundle did not install: "
                               f"{srv}")
        bad = srv["lenet-corrupt"]
        if (bad["aot_fallback_total"] != 1
                or bad["aot_buckets"] != len(buckets) - 1
                or bad["xla_compiles_total"] != 1):
            raise RuntimeError(f"[aot-restart] the corrupt artifact: {bad}")
        out = {"boot_to_ready_s": res["boot_to_ready_s"],
               "child_imports_s": res["imports_s"],
               "child_s": child_s, "first_build_s": build_s,
               "save_s": save_s, "nvcc_builds": res["cache_stats"]["misses"],
               "library_hits": res["cache_stats"]["hits"],
               "servers": srv, "launches": res["launches"]}
        print(f"[aot-restart] {json.dumps(out)} card={card}")
        return res["launches"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(cache, ignore_errors=True)


# --- the continuous-learning loop, early stopping and evaluate ----------

LOOP_PUBLISH = 8           # optimizer steps between publishes
LOOP_BUCKETS = (1, 8, 32)  # the serving ladder and the AOT bundle's
LOOP_CLIENTS = 4
LOOP_POOL = 512            # held-out rows the clients draw from
LOOP_HOT = 255.0           # the shift: pixel (0, 0) sent raw, unscaled
LOOP_BOMB_LOGIT = 40.0     # the bomb's output weights, +-
LOOP_MIN_AGREEMENT = 0.8  # step 8 vs 16 agree on 0.94 of the pool (CPU)
LOOP_SHADOW_REQUESTS = 32
LOOP_WAIT_S = 180.0
EARLYSTOP_BATCHES = 8      # minibatches of 256 an epoch
EARLYSTOP_HOLDOUT = 4
EARLYSTOP_MAX_EPOCHS = 6
EARLYSTOP_PATIENCE = 2
EVAL_BATCH = 128           # VGG-16's (bench.py:480)
EVAL_BATCHES = 2
TWIN_RTOL, TWIN_ATOL = 2e-4, 2e-5  # [fleet]'s twin tolerance


def wait_for(cond, what, timeout=None, every=0.01, detail=None):
    """Poll ``cond`` until true; raise naming ``what`` (and ``detail()``)
    at the deadline (``timeout`` seconds, default LOOP_WAIT_S)."""
    timeout = LOOP_WAIT_S if timeout is None else timeout
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise RuntimeError(f"timed out after {timeout:.0f} s waiting "
                               f"for {what}"
                               + (f": {detail()}" if detail else ""))
        time.sleep(every)


def loop_pool(seed=0):
    """LOOP_POOL held-out synthetic MNIST rows (``datasets/mnist.py``,
    the test split), pixel (0, 0) set to 0."""
    import warnings

    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        x = next(iter(MnistDataSetIterator(
            LOOP_POOL, train=False, allow_synthetic=True,
            num_examples=LOOP_POOL, seed=seed))).features.copy()
    x[:, 0] = 0.0
    return x


def hot(rows):
    """``rows`` with pixel (0, 0) at LOOP_HOT."""
    out = np.array(rows, np.float32)
    out[:, 0] = LOOP_HOT
    return out


class LoopClients:
    """LOOP_CLIENTS HTTP clients, each sending 1-4 seeded rows of the pool
    a request (``shift`` set: with pixel (0, 0) hot; ``pause`` set:
    none) until stopped.
    ``records``: (wall start, seconds, status or None when the request
    was lost, model_version, rows, output, shifted)."""

    def __init__(self, port, pool):
        self.port, self.pool = port, pool
        self.shift = threading.Event()
        self.pause = threading.Event()
        self._stop = threading.Event()
        self.lock = threading.Lock()
        self.records = []
        self.threads = [threading.Thread(target=self._run, args=(i,),
                                         daemon=True)
                        for i in range(LOOP_CLIENTS)]

    def start(self):
        for t in self.threads:
            t.start()
        return self

    def _run(self, i):
        rng = np.random.RandomState(300 + i)
        while not self._stop.is_set():
            if self.pause.is_set():
                time.sleep(0.01)
                continue
            x = self.pool[rng.randint(0, len(self.pool),
                                      rng.randint(1, 5))]
            shifted = self.shift.is_set()
            if shifted:
                x = hot(x)
            t0 = time.time()
            try:
                code, body, _, dt = post_json(self.port,
                                              {"features": x.tolist()})
            except OSError:
                code, body, dt = None, {}, time.time() - t0
            out = (np.asarray(body["output"], np.float32) if code == 200
                   else None)
            with self.lock:
                self.records.append((t0, dt, code, body.get("model_version"),
                                     x, out, shifted))

    def count(self):
        with self.lock:
            return len(self.records)

    def wait(self, n, what):
        """Until ``n`` more requests are answered."""
        base = self.count()
        wait_for(lambda: self.count() >= base + n, what)

    def stop(self):
        self._stop.set()
        for t in self.threads:
            t.join(timeout=120)
            if t.is_alive():
                raise RuntimeError("[loop] a client did not stop")


def journal_times(journal, since):
    """{state or "sealed": wall seconds} of the first transition into
    each state journaled after ``since``."""
    out = {}
    for h in journal.read()["history"]:
        if h["at"] < since:
            continue
        key = ("sealed" if h["state"] == "promoted" and not h.get("probation")
               else h["state"])
        out.setdefault(key, h["at"])
    return out


def regression_bomb(torch, live, pool):
    """A copy of ``live`` (LeNet-5) that answers every ``pool`` row
    bitwise as ``live`` does and diverges once pixel (0, 0) is hot.

    A conv weight multiplies every position of its input, so no conv1
    tap sees pixel (0, 0) alone; the last pool's position-(0, 0)
    features are the only ones the pixel reaches. The dense unit that is
    most surely dead (relu 0) on every pool row is rewired into a
    detector of those features' shift, thresholded halfway between the
    pool's largest projection and the hot pool's smallest, with output
    weights +-LOOP_BOMB_LOGIT: on the pool the unit stays exactly 0 and
    adds exact zeros to the logits. Returns (bomb, unit, agreement with
    ``live`` on the hot pool)."""
    dense, out_layer = live.layer_names[4], live.layer_names[5]
    acts = live.feed_forward(pool)
    ahot = live.feed_forward(hot(pool))
    flat = acts[3].reshape(len(pool), -1)
    pre = flat @ live.params[dense]["W"] + live.params[dense]["b"]
    worst = pre.max(dim=0).values
    unit = int(worst.argmin())
    if float(worst[unit]) >= -1e-3:
        raise RuntimeError("[loop] no dense unit is dead on the pool")
    f0, f1 = acts[3][:, :, 0, 0], ahot[3][:, :, 0, 0]
    w = (f1 - f0).mean(dim=0)
    p0, p1 = f0 @ w, f1 @ w
    top, low = float(p0.max()), float(p1.min())
    if not low > top:
        raise RuntimeError(f"[loop] the hot corner does not separate: "
                           f"{low} <= {top}")
    gain = 2.0 / (low - top)
    bomb = live.copy()
    bomb.iteration_count = live.iteration_count
    wd = bomb.params[dense]["W"]
    wd[:, unit] = 0.0
    channels = acts[3].shape[1]
    wd[torch.arange(channels, device=wd.device) * (flat.shape[1] // channels),
       unit] = gain * w
    bomb.params[dense]["b"][unit] = -gain * (top + low) / 2.0
    sign = torch.ones(bomb.params[out_layer]["W"].shape[1],
                      device=wd.device)
    sign[1::2] = -1.0
    bomb.params[out_layer]["W"][unit] = LOOP_BOMB_LOGIT * sign
    if not torch.equal(bomb.output(pool), live.output(pool)):
        raise RuntimeError("[loop] the bomb changes answers on the pool")
    agree = float((bomb.output(hot(pool)).argmax(1)
                   == live.output(hot(pool)).argmax(1)).float().mean())
    return bomb, unit, agree


def run_loop(torch, card, device="cuda", conf=None):
    """[loop] the continuous-learning loop on LeNet-5 (Adam, batch 256 as
    bench.py:239, seeded synthetic MNIST) under live HTTP traffic: a
    ``ContinualTrainer`` publishing every 8 steps with the serving bundle
    of buckets 1, 8, 32; a ``ModelServer`` on its ``CheckpointManager``;
    a ``Promoter`` with its journal; LOOP_CLIENTS clients sending held-out
    rows whose pixel (0, 0) is 0. Stages: A a good candidate (step 16)
    shadowed, canaried, promoted, sealed, its answers against a CPU twin;
    B a byte-flipped candidate quarantined; C a candidate with its output
    classes rolled rejected at the shadow gates; D ``regression_bomb``
    promoted, the clients' pixel (0, 0) turned hot, the promotion rolled
    back (no new shape, no 5xx, no request lost, the answers bitwise the
    pre-bomb version's); E ``fail_after_journal="canarying"`` and a fresh
    promoter's ``recover()`` rolling forward; F a second trainer resumed
    from the store, its next publish bitwise an uninterrupted trainer's.
    Returns the launch counts of the phase. ``conf`` and ``device="cpu"``
    rehearse it (without the bundle: no library there)."""
    import shutil
    import tempfile
    import warnings

    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.loop import (
        ContinualTrainer,
        Promoter,
        PromotionGates,
        PromotionJournal,
        SimulatedKill,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
    )
    from deeplearning4j_tpu_torch.serving import ModelServer
    from deeplearning4j_tpu_torch.zoo import lenet

    conf = conf or lenet()
    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        batches = list(MnistDataSetIterator(
            LENET_TRAIN_BATCH, allow_synthetic=True,
            num_examples=LENET_TRAIN_BATCH * 5 * LOOP_PUBLISH))
    pool = loop_pool()
    tmp = tempfile.mkdtemp(prefix="dl4j_loop_")
    server = clients = pr = None
    try:
        dispatch.reset_launch_counts()
        mgr = CheckpointManager(f"{tmp}/ckpt", keep_last=10, device=device)
        journal = PromotionJournal(f"{tmp}/journal.json")
        model = MultiLayerNetwork(conf, device=device).init()
        ct = ContinualTrainer(model, mgr, publish_every=LOOP_PUBLISH,
                              aot_buckets=list(LOOP_BUCKETS), journal=journal)

        def train():
            """The next LOOP_PUBLISH minibatches, published at their end."""
            n = model.iteration_count
            t0 = time.perf_counter()
            ct.run(batches[n:n + LOOP_PUBLISH])
            return ct.last_published, time.perf_counter() - t0

        def until(cond, what):
            """``wait_for`` showing the journal and the promoter."""
            def detail():
                doc = {k: v for k, v in journal.read().items()
                       if k != "history"}
                return json.dumps({"journal": doc, "promoter": pr.snapshot()
                                   if pr is not None else None},
                                  default=str)
            wait_for(cond, what, detail=detail)

        boot, boot_s = train()
        t0 = time.perf_counter()
        server = ModelServer(
            checkpoint_manager=mgr, device=device, workers=8, queue_depth=64,
            bucket_ladder=list(LOOP_BUCKETS), batch_timeout_ms=2.0).start()
        start_s = time.perf_counter() - t0
        installed = []  # every scorer the promoter installs, in order
        set_shadow = server.set_shadow

        def record_shadow(scorer):
            if scorer is not None:
                installed.append(scorer)
            set_shadow(scorer)

        server.set_shadow = record_shadow
        m = server.metrics.get
        post_warmup0, compiles0 = (m("post_warmup_compiles_total"),
                                   m("xla_compiles_total"))
        clients = LoopClients(server.port, pool).start()
        t_base = time.time()
        clients.wait(64, "the baseline traffic")
        # no latency gate (JAX's default): the shadow forward runs just
        # after the responses, while the handler threads parse the next
        # requests, so its host clock carries their interpreter-lock
        # contention (PERF.md §6); the delta is printed
        gates = PromotionGates(
            min_shadow_requests=LOOP_SHADOW_REQUESTS,
            min_agreement=LOOP_MIN_AGREEMENT, max_shadow_errors=0,
            probation_requests=LOOP_SHADOW_REQUESTS)
        pr = Promoter(server, mgr, journal, gates=gates, seed=1337)
        if pr.recover() != "idle":
            raise RuntimeError("[loop] a fresh journal did not recover idle")
        res = {"boot_step": boot.step, "boot_train_publish_s": boot_s,
               "server_start_s": start_s,
               "aot_buckets_at_start": server._aot_buckets}

        # A: a good candidate, shadow -> canary -> promoted -> sealed
        pr.run(interval=0.02)
        t_train = time.time()
        info_a, train_s = train()
        t_pub = time.time()
        until(lambda: (journal.read()["promoted_step"] == info_a.step
                       and not journal.read()["probation"]),
              "stage A's promotion to seal")
        times = journal_times(journal, t_pub)
        cand, prob = installed[0].snapshot(), installed[1].snapshot()
        t_seal = times["sealed"]
        v_a = server.model_version
        clients.wait(64, "traffic on the sealed version")
        # the candidate's forward on 8 rows with the handler threads idle
        # (clients paused), beside its ms in the post-response window
        clients.pause.set()
        time.sleep(0.2)
        idle = []
        for _ in range(20):
            t0 = time.perf_counter()
            installed[0]._forward(pool[:8])
            idle.append((time.perf_counter() - t0) * 1e3)
        clients.pause.clear()
        recs = list(clients.records)

        def p50_ms(lo, hi):
            """The p50 latency of the requests sent in [lo, hi)."""
            s = [r[1] for r in recs if lo <= r[0] < hi and r[2] == 200]
            return float(np.median(s)) * 1e3 if s else None

        twins = {1: mgr.restore(boot, load_updater=False, device="cpu"),
                 v_a: mgr.restore(info_a, load_updater=False, device="cpu")}
        err = 0.0
        for version, twin in twins.items():
            mine = [r for r in recs if r[3] == version and r[2] == 200]
            got = np.concatenate([r[5] for r in mine])
            ref = twin.output(np.concatenate([r[4] for r in mine])).numpy()
            np.testing.assert_allclose(got, ref, rtol=TWIN_RTOL,
                                       atol=TWIN_ATOL,
                                       err_msg=f"[loop] version {version}")
            err = max(err, float(np.abs(got - ref).max()))
        res["A"] = {
            "step": info_a.step, "train_and_publish_s": train_s,
            "ms_from_publish": {k: (v - t_pub) * 1e3
                                for k, v in times.items()},
            "shadow_agreement": cand["agreement"],
            "shadow_mirrored": cand["shadowed"],
            "shadow_p99_delta_ms": cand["p99_delta_ms"],
            "shadow_candidate_p99_ms": cand["candidate_p99_ms"],
            "shadow_live_p99_ms": cand["live_p99_ms"],
            "shadow_candidate_p50_ms": cand["candidate_p50_ms"],
            "shadow_live_p50_ms": cand["live_p50_ms"],
            "candidate_idle_p50_ms": float(np.median(idle)),
            "probation_agreement": prob["agreement"],
            "probation_shadow_p50_ms": prob["candidate_p50_ms"],
            "probation_live_p50_ms": prob["live_p50_ms"],
            "p50_ms_no_shadow": p50_ms(t_base, t_train),
            "p50_ms_training": p50_ms(t_train, t_pub),
            "p50_ms_shadowing": p50_ms(times["shadowing"],
                                       times["canarying"]),
            "p50_ms_sealed": p50_ms(t_seal, float("inf")),
            "twin_max_abs_err": err, "version": v_a}

        # B: a byte-flipped candidate is quarantined
        pr.stop()
        info_b, _ = train()
        path = mgr.directory / info_b.file
        raw = bytearray(path.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        path.write_bytes(bytes(raw))
        t_pub = time.time()
        pr.run(interval=0.02)
        until(lambda: info_b.step in journal.read()["quarantined_steps"],
              "stage B's quarantine")
        clients.wait(32, "traffic after the quarantine")
        if server.model_version != v_a or server._watched_step != info_a.step:
            raise RuntimeError("[loop] the quarantine moved the live version")
        res["B"] = {"step": info_b.step, "ms_to_quarantine": (
            journal_times(journal, t_pub)["quarantined"] - t_pub) * 1e3}

        # C: the live weights with the output classes rolled by one
        pr.stop()
        rolled = mgr.restore(info_a, load_updater=False, device=device)
        last = rolled.layer_names[-1]
        rolled.params[last] = {
            "W": torch.roll(rolled.params[last]["W"], 1, dims=1),
            "b": torch.roll(rolled.params[last]["b"], 1, dims=0)}
        rolled.iteration_count = info_b.step + 1
        info_c = mgr.save(rolled)
        n_installed = len(installed)
        t_pub = time.time()
        pr.run(interval=0.02)
        until(lambda: info_c.step in journal.read()["rejected_steps"],
              "stage C's rejection")
        if server.model_version != v_a:
            raise RuntimeError("[loop] the rejected candidate took traffic")
        res["C"] = {"step": info_c.step,
                    "shadow_agreement": installed[n_installed].snapshot()[
                        "agreement"],
                    "reason": journal.read()["reason"],
                    "ms_to_reject": (journal_times(journal, t_pub)[
                        "rolled_back"] - t_pub) * 1e3}

        # D: the regression bomb, promoted, then the shift goes live
        pr.stop()
        live = mgr.restore(info_a, load_updater=False, device=device)
        bomb, unit, hot_agree = regression_bomb(torch, live, pool)
        bomb.iteration_count = info_c.step + 1
        info_d = mgr.save(bomb)
        probe = np.concatenate([pool[:4], hot(pool[4:8])])
        before = server.submit(probe)[1]["output"]
        pr.gates = PromotionGates(
            min_shadow_requests=LOOP_SHADOW_REQUESTS,
            min_agreement=LOOP_MIN_AGREEMENT, max_shadow_errors=0,
            probation_requests=10 ** 9,  # only the shift ends probation
            probation_min_agreement=LOOP_MIN_AGREEMENT)
        n_records = clients.count()
        t_pub = time.time()
        pr.run(interval=0.02)
        until(lambda: (journal.read()["promoted_step"] == info_d.step
                       and journal.read()["probation"]),
              "stage D's promotion")
        # the promotion's reload warmed the bomb's buckets; from here on
        # no shape may be new
        compiles, post_warmup = (m("xla_compiles_total"),
                                 m("post_warmup_compiles_total"))
        clients.wait(32, "traffic on the promoted bomb")
        t_shift = time.time()
        clients.shift.set()
        until(lambda: info_d.step in journal.read()["rejected_steps"],
              "stage D's rollback")
        clients.wait(32, "shifted traffic after the rollback")
        clients.shift.clear()
        clients.wait(32, "traffic after the shift")
        after = server.submit(probe)[1]["output"]
        times = journal_times(journal, t_pub)
        lost = [r for r in clients.records[n_records:] if r[2] != 200]
        if (after != before or lost
                or m("xla_compiles_total") != compiles
                or m("post_warmup_compiles_total") != post_warmup
                or server.model_version != v_a
                or journal.read()["promoted_step"] != info_a.step):
            raise RuntimeError(
                f"[loop] the rollback: answers bitwise {after == before}, "
                f"{len(lost)} lost or non-200, compiles {compiles} -> "
                f"{m('xla_compiles_total')}, post-warmup {post_warmup} -> "
                f"{m('post_warmup_compiles_total')}, version "
                f"{server.model_version} (want {v_a})")
        snap = pr.snapshot()
        res["D"] = {"step": info_d.step, "dead_unit": unit,
                    "hot_pool_agreement": hot_agree,
                    "ms_from_publish": {k: (v - t_pub) * 1e3
                                        for k, v in times.items()},
                    "rollback_ms_from_shift": (times["rolled_back"]
                                               - t_shift) * 1e3,
                    "rollback_swap_ms": snap["rollback_swap_ms"],
                    "snapshot_pagein_ms": snap["snapshot_pagein_ms"],
                    "reason": journal.read()["reason"],
                    "requests": clients.count() - n_records, "lost": 0,
                    "answers_bitwise_pre_bomb": True}
        pr.gates = gates

        # E: killed right after journaling canarying; a fresh promoter
        # recovers and rolls forward
        pr.stop()
        info_e, _ = train()
        pr.fail_after_journal = "canarying"
        t_pub = time.time()
        deadline = time.monotonic() + LOOP_WAIT_S
        while True:
            try:
                pr.poll()
            except SimulatedKill:
                break
            if time.monotonic() > deadline:
                raise RuntimeError("[loop] stage E never reached canarying")
            time.sleep(0.02)
        t_kill = time.perf_counter()
        split = journal.read()["state"]
        pr = Promoter(server, mgr, journal, gates=gates, seed=1337)
        state = pr.recover()
        recover_ms = (time.perf_counter() - t_kill) * 1e3
        if (split != "canarying" or state != "promoted"
                or journal.read()["promoted_step"] != info_e.step
                or server._watched_step != info_e.step):
            raise RuntimeError(f"[loop] recovery: journal {split} -> {state},"
                               f" serving step {server._watched_step}")
        pr.run(interval=0.02)
        until(lambda: not journal.read()["probation"],
              "stage E's promotion to seal")
        res["E"] = {"step": info_e.step, "split_state": split,
                    "recover_ms": recover_ms,
                    "ms_publish_to_canarying": (journal_times(
                        journal, t_pub)["canarying"] - t_pub) * 1e3,
                    "serving_step": server._watched_step,
                    "journal_recoveries": pr.snapshot()[
                        "journal_recoveries"]}
        pr.stop()
        clients.stop()
        statuses = [r[2] for r in clients.records]
        if set(statuses) != {200} or m("server_error_total"):
            raise RuntimeError(f"[loop] statuses "
                               f"{sorted(set(statuses), key=str)}, server "
                               f"errors {m('server_error_total')}")
        if m("post_warmup_compiles_total") != post_warmup0:
            raise RuntimeError("[loop] a shape escaped the warmed ladder")

        # F: a second trainer resumed from the store against the
        # uninterrupted one, over the same next minibatches
        ct2 = ContinualTrainer(
            MultiLayerNetwork(conf, device=device).init(),
            CheckpointManager(f"{tmp}/ckpt", keep_last=10, device=device),
            publish_every=LOOP_PUBLISH, journal=journal)
        resumed = ct2.resume()
        n = model.iteration_count
        ct2.run(batches[n:n + LOOP_PUBLISH])
        for ds in batches[n:n + LOOP_PUBLISH]:
            model.fit_minibatch(ds)
        pub = mgr.restore(ct2.last_published, device=device)
        same = same_trees(torch, model, pub)
        if resumed != info_e.step or not same:
            raise RuntimeError(f"[loop] resume from step {resumed}: the next "
                               f"publish bitwise the uninterrupted trainer's:"
                               f" {same}")
        res["F"] = {"resumed_step": resumed,
                    "published_step": ct2.last_published.step,
                    "bitwise_uninterrupted": True}
        launches = dispatch.launch_counts()
        res.update(requests=len(statuses), non_200=0,
                   server_error_total=m("server_error_total"),
                   xla_compiles_total=m("xla_compiles_total") - compiles0,
                   post_warmup_compiles_total=m("post_warmup_compiles_total"),
                   aot_fallback_total=getattr(server.metrics.registry.get(
                       "aot_fallback_total"), "value", 0),
                   journal=[(h["state"], h.get("candidate_step"),
                             h.get("promoted_step"), h.get("probation"))
                            for h in journal.read()["history"]],
                   launches=launches)
        print(f"[loop] {json.dumps(res)} card={card}")
        return launches
    finally:
        if pr is not None:
            pr.stop()
        if clients is not None:
            clients.stop()
        if server is not None:
            server.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def run_earlystop(torch, card, device="cuda", conf=None):
    """[earlystop] ``EarlyStoppingTrainer`` on LeNet-5 (Adam, batch 256,
    seeded synthetic MNIST): EARLYSTOP_BATCHES minibatches an epoch,
    ``MaxEpochsTerminationCondition(6)`` and
    ``ScoreImprovementEpochTerminationCondition(2)``, a
    ``DataSetLossCalculator`` over EARLYSTOP_HOLDOUT held-out minibatches
    and an ``InMemoryModelSaver``; the best model's ``evaluate`` on the
    holdout; the calculator's best score against the same calculator on
    the best model's CPU twin. Returns the launch counts of the phase."""
    import warnings

    from deeplearning4j_tpu_torch.datasets import (
        ListDataSetIterator,
        MnistDataSetIterator,
    )
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator,
        EarlyStoppingConfiguration,
        EarlyStoppingTrainer,
        InMemoryModelSaver,
        MaxEpochsTerminationCondition,
        ScoreImprovementEpochTerminationCondition,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.zoo import lenet

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        train = list(MnistDataSetIterator(
            LENET_TRAIN_BATCH, allow_synthetic=True, seed=11,
            num_examples=LENET_TRAIN_BATCH * EARLYSTOP_BATCHES))
        holdout = list(MnistDataSetIterator(
            LENET_TRAIN_BATCH, train=False, allow_synthetic=True, seed=12,
            num_examples=LENET_TRAIN_BATCH * EARLYSTOP_HOLDOUT))
    net = MultiLayerNetwork(conf or lenet(), device=device).init()
    calc = DataSetLossCalculator(ListDataSetIterator(holdout))
    cfg = EarlyStoppingConfiguration(
        score_calculator=calc,
        epoch_terminations=[
            MaxEpochsTerminationCondition(EARLYSTOP_MAX_EPOCHS),
            ScoreImprovementEpochTerminationCondition(EARLYSTOP_PATIENCE)],
        model_saver=InMemoryModelSaver())
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    result = EarlyStoppingTrainer(cfg, net, ListDataSetIterator(train)).fit()
    fit_s = time.perf_counter() - t0
    best = result.best_model
    t1 = time.perf_counter()
    ev = best.evaluate(ListDataSetIterator(holdout))
    eval_ms = (time.perf_counter() - t1) * 1e3
    launches = dispatch.launch_counts()
    twin_score = calc.calculate_score(cpu_twin(torch, best))
    if not (best is not net and result.best_model_epoch >= 0
            and abs(twin_score - result.best_model_score)
            <= TWIN_ATOL + TWIN_RTOL * abs(twin_score)):
        raise RuntimeError(f"[earlystop] best score {result.best_model_score}"
                           f" against the CPU twin's {twin_score}")
    if device == "cuda" and min(launches[k] for k in (
            "conv_block", "conv_bwd_data", "conv_bwd_w", "matmul_block")) <= 0:
        raise RuntimeError(f"[earlystop] a kernel did not launch: {launches}")
    res = {"epochs": result.total_epochs,
           "best_epoch": result.best_model_epoch,
           "termination": [result.termination_reason,
                           result.termination_details],
           "scores": {str(k): v for k, v in result.score_vs_epoch.items()},
           "best_score": result.best_model_score,
           "twin_best_score": twin_score,
           "ms_per_epoch": fit_s * 1e3 / result.total_epochs,
           "best_accuracy": ev.accuracy(), "best_f1": ev.f1(),
           "evaluate_ms": eval_ms, "steps": net.iteration_count,
           "launches": launches}
    print(f"[earlystop] {json.dumps(res)} card={card}")
    return launches


def run_evaluate(torch, card, device="cuda", conf=None):
    """[evaluate] ``ComputationGraph.evaluate`` of VGG-16 (``zoo.vgg16``,
    BASELINE #2, seeded random weights) over EVAL_BATCHES held-out
    synthetic CIFAR minibatches of 128, with ``Evaluation`` and
    ``ROCMultiClass``; the predicted classes against the CPU twin's on
    every row whose top-2 margin clears the twin tolerance. Returns the
    launch counts of the phase."""
    import warnings

    from deeplearning4j_tpu_torch.datasets import (
        CifarDataSetIterator,
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.eval import ROCMultiClass
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.zoo import vgg16

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        data = list(CifarDataSetIterator(
            EVAL_BATCH, train=False, allow_synthetic=True, seed=13,
            num_examples=EVAL_BATCH * EVAL_BATCHES))
    graph = ComputationGraph(conf or vgg16(), device=device).init()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    ev = graph.evaluate(ListDataSetIterator(data))
    eval_ms = (time.perf_counter() - t0) * 1e3
    roc = ROCMultiClass()
    outs = []
    for ds in data:
        out = graph.output(ds.features)[0]
        roc.eval(ds.labels, out)
        outs.append(out.float().cpu().numpy())
    launches = dispatch.launch_counts()
    got = np.concatenate(outs)
    labels = np.concatenate([ds.labels for ds in data])
    own = np.zeros((10, 10), np.int64)
    np.add.at(own, (labels.argmax(1), got.argmax(1)), 1)
    if not np.array_equal(ev.confusion.matrix, own):
        raise RuntimeError("[evaluate] evaluate's confusion matrix is not "
                           "the one of the graph's own outputs")
    twin = cpu_twin(torch, graph)
    ref = np.concatenate([twin.output(ds.features)[0].numpy()
                          for ds in data])
    np.testing.assert_allclose(got, ref, rtol=TWIN_RTOL, atol=TWIN_ATOL,
                               err_msg="[evaluate] outputs vs the CPU twin")
    # a row's class is held against the twin's where its top-2 margin is
    # more than the twin tolerance either side of it
    top2 = np.sort(ref, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * (TWIN_ATOL
                                             + TWIN_RTOL * top2[:, 1])
    if not np.array_equal(got[clear].argmax(1), ref[clear].argmax(1)):
        raise RuntimeError("[evaluate] classes differ from the CPU twin's "
                           "on rows with a clear margin")
    err = float(np.abs(got - ref).max())
    beyond_err = (top2[:, 1] - top2[:, 0]) > 2 * err
    same_class = got.argmax(1) == ref.argmax(1)
    twin_roc = ROCMultiClass()
    for ds, r in zip(data, np.split(ref, EVAL_BATCHES)):
        twin_roc.eval(ds.labels, r)
    if device == "cuda" and min(launches[k] for k in (
            "conv_block", "matmul_block")) <= 0:
        raise RuntimeError(f"[evaluate] a kernel did not launch: {launches}")
    res = {"rows": int(len(got)), "accuracy": ev.accuracy(),
           "confusion_total": ev.confusion.total(),
           "evaluate_ms": eval_ms,
           "rows_under_margin": int((~clear).sum()),
           "max_abs_err_vs_twin": err,
           "output_range": [float(got.min()), float(got.max())],
           "rows_margin_over_2x_err": int(beyond_err.sum()),
           "same_class_as_twin": int(same_class.sum()),
           "average_auc": roc.calculate_average_auc(),
           "twin_average_auc": twin_roc.calculate_average_auc(),
           "launches": launches}
    print(f"[evaluate] {json.dumps(res)} card={card}")
    return launches


# -- the networks of the MoE / GoogLeNet / graph-RNN slice ---------------------

GOOGLENET_BATCH = 128       # ImageNet at bench.py:823's batch, as [resnet50]
GOOGLENET_TWIN_BATCH = 4
GOOGLENET_STEPS = 6
MOE_EXPERTS = 4             # examples/transformer_lm.py:62
MOE_LAYERS = 6              # depth cut from bench.py:866's 12 for time
MOE_STEPS = 20
MOE_DEFAULT_FIT_BATCHES = 4
MOE_SAMPLE = 32
MOE_MIN_AGREEMENT = 0.99    # card / CPU routing of the same operands
GRAPH_CHAR_MINIBATCHES = 1  # cut from 2 for time
CONV_LSTM_BATCH = 32        # sequences of CONV_LSTM_T 28 x 28 frames
CONV_LSTM_T = 16
CONV_LSTM_STEPS = 16
CONV_LSTM_TWIN_BATCH = 2
# the main paths of this slice, in the order main() runs them; the
# kernels line sums each kernel's launches over them by name
NETWORK_PATHS = ("googlenet", "moe-transformer", "moe-ep", "graph-charrnn",
                 "conv-lstm")


def network_phases(records, tokens, ids):
    """(tag, function, extra arguments) of each phase of NETWORK_PATHS."""
    return (("googlenet", run_googlenet, (records,)),
            ("moe-transformer", run_moe_transformer, (tokens,)),
            ("moe-ep", run_moe_ep, ()),
            ("graph-charrnn", run_graph_charrnn, (ids,)),
            ("conv-lstm", run_conv_lstm, ()))


def googlenet_shapes(batch=GOOGLENET_BATCH):
    """The distinct kernel shapes of one GoogLeNet training step at
    ``batch`` (224 x 224): (first vertex, kind, geometry, vertices)."""
    from deeplearning4j_tpu_torch.zoo import googlenet

    return distinct_shapes(step_shapes(graph_kernel_shapes(googlenet(),
                                                           batch)))


def standardized(batches):
    """uint8 ImageNet minibatches as standardized f32 pixels ((p - 127.5)
    / 73.9): a net without BatchNormalization diverges on raw 0-255
    pixels."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    return [DataSet((b.features.astype(np.float32) - 127.5) / 73.9,
                    b.labels.astype(np.float32)) for b in batches]


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def run_googlenet(torch, card, records):
    """[googlenet] the zoo's GoogLeNet (Inception v1 without the
    auxiliary heads) at 224 x 224 x 3, 1000 classes, f32, NESTEROVS lr
    0.01, as a ``ComputationGraph``: ``output`` at batch 128 on uint8
    pixels (57 conv launches); two batch-4 steps each held against the
    CPU twin from the same state, every conv kernel call held against
    its plain version on the same operands; one step's launches exact
    (114 ``conv_block``, 56 ``conv_bwd_data``, 57 ``conv_bwd_w``); then
    the main path, 6 steps at batch 128 over which the first
    minibatch's score falls. ``records``: the [kernel] records, which
    must hold each of its step's distinct shapes. Returns the launch
    counts of the main path."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.zoo import googlenet

    shapes = googlenet_shapes()
    held_shapes = {(r["kernel"], r["shape_of"]) for r in records}
    missing = [(k, n) for n, k, _, _ in shapes
               if (k, f"googlenet.{n}") not in held_shapes]
    if missing:
        raise RuntimeError(f"[googlenet] shapes not held: {missing[:5]}")
    conf = googlenet(learning_rate=0.01)
    net = per_step_loop(ComputationGraph(conf, device="cuda").init())
    init = {ln: {pn: t.clone() for pn, t in lp.items()}
            for ln, lp in net.params.items()}
    n_conv = sum(len(s[3]) for s in shapes if s[1] == "conv_block")
    print(f"[googlenet] zoo.googlenet() as a ComputationGraph "
          f"({net.num_params()} params, {n_conv} convs, "
          f"{sum(1 for s in shapes if s[1] == 'conv_block')} distinct), "
          f"224x224x3, 1000 classes, NESTEROVS lr 0.01, batch "
          f"{GOOGLENET_BATCH}, f32")
    main = {}
    raw = resnet_batches(2, GOOGLENET_BATCH, seed=51)
    dispatch.reset_launch_counts()
    out = net.output(raw[0].features)[0]
    torch.cuda.synchronize()
    per_output = dispatch.launch_counts()
    if per_output != expected_counts(conv_block=n_conv):
        raise RuntimeError(f"[googlenet] output launched {per_output}")
    add_counts(main, per_output)
    if out.shape != (GOOGLENET_BATCH, 1000) or not bool(
            torch.isfinite(out).all()):
        raise RuntimeError(f"[googlenet] bad output {tuple(out.shape)}")
    batches = standardized(raw)
    # two batch-4 steps, card and CPU twin from the same state each
    small = [type(b)(b.features[:GOOGLENET_TWIN_BATCH],
                     b.labels[:GOOGLENET_TWIN_BATCH]) for b in batches]
    a = per_step_loop(ComputationGraph(conf, device="cuda").init(params=init))
    twin = cpu_twin(torch, a)
    out_err = close_to_scale(torch, a.output(small[0].features)[0].cpu(),
                             twin.output(small[0].features)[0], 1e-4)
    card_scores, cpu_scores, worst = [], [], 0.0
    held = held_on_operands()
    for ds in small:
        before = {ln: {pn: t.cpu() for pn, t in lp.items()}
                  for ln, lp in a.params.items()}
        twin.params = before
        twin.updater_state = {ln: {pn: tuple(t.cpu() for t in tup)
                                   for pn, tup in lp.items()}
                              for ln, lp in a.updater_state.items()}
        with held:
            a.fit(ds)
        twin.fit(ds)
        card_scores.append(a.score_value)
        cpu_scores.append(twin.score_value)
        worst = max(worst, check_twin_step("googlenet", a, twin, before))
    np.testing.assert_allclose(card_scores, cpu_scores, rtol=1e-4)
    want_held = {"conv_block": 4 * n_conv, "conv_bwd_data": 2 * (n_conv - 1),
                 "conv_bwd_w": 2 * n_conv}
    if {k: n for k, (n, _) in held.errors.items()} != want_held:
        raise RuntimeError(f"[googlenet] held calls: {held.errors}")
    del a, twin
    dispatch.reset_launch_counts()
    net.fit(batches[1])
    torch.cuda.synchronize()
    per_step = dispatch.launch_counts()
    if per_step != expected_counts(conv_block=2 * n_conv,
                                   conv_bwd_data=n_conv - 1,
                                   conv_bwd_w=n_conv):
        raise RuntimeError(f"[googlenet] one step launched {per_step}")
    del net
    model = per_step_loop(ComputationGraph(conf, device="cuda").init(
        params=init))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    scores = []
    t0 = time.perf_counter()
    for _ in range(GOOGLENET_STEPS // len(batches)):
        for ds in batches:
            scores.append(model.fit_minibatch(ds))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    if launches != {k: v * GOOGLENET_STEPS for k, v in per_step.items()}:
        raise RuntimeError(f"[googlenet] the main path launched {launches}")
    add_counts(main, launches)
    peak = torch.cuda.max_memory_allocated()
    scores = [float(s) for s in scores]
    if not all(np.isfinite(scores)) or not scores[-2] < scores[0]:
        raise RuntimeError(f"[googlenet] the score did not fall: {scores}")
    device_ms, top = profiled_device_ms(torch, lambda: model.fit(batches))
    device_ms /= len(batches)
    ms = wall / GOOGLENET_STEPS * 1e3
    res = {"steps": GOOGLENET_STEPS, "batch": GOOGLENET_BATCH,
           "examples_per_s": GOOGLENET_STEPS * GOOGLENET_BATCH / wall,
           "host_ms_per_step": ms, "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / ms,
           "top_device_ms_per_step": {k[:60]: v / len(batches)
                                      for k, v in top.items()},
           "scores": scores, "peak_memory_gb": peak / 1e9,
           "launches_per_output": {k: v for k, v in per_output.items() if v},
           "launches_per_step": {k: v for k, v in per_step.items() if v},
           "twin_output_max_abs_err": out_err,
           "twin_scores": {"card": card_scores, "cpu": cpu_scores},
           "twin_max_share_of_move": worst,
           "kernels_on_operands_max_rel_err": {
               k: e for k, (_, e) in held.errors.items()},
           "distinct_kernel_shapes_held": len(shapes)}
    print(f"[googlenet] {json.dumps(res)} card={card}")
    return main


def moe_conf():
    """bench.py:866's transformer LM at MOE_LAYERS of its 12 layers (full
    width) with a Switch MoE FFN of 4 experts in every block (hidden
    3072, capacity factor 1.25)."""
    from deeplearning4j_tpu_torch.zoo import transformer_lm

    return transformer_lm(**dict(TX, n_layers=MOE_LAYERS),
                          n_experts=MOE_EXPERTS)


class held_moe:
    """Within the block, every ``moe_ffn`` call (the slot dispatch of the
    main path) is held against the dense plain version
    (``moe_ffn_reference``: the one-hot ``einsum``s) on the same
    operands on the card, and its routing against the CPU's routing of
    copies of the same operands: ``calls``, ``worst`` (the largest
    error relative to the plain result's largest entry), ``tokens`` and
    ``agree`` (tokens routed to the same slot on both)."""

    def __init__(self, torch, rel: float = 1e-6):
        self.torch, self.rel = torch, rel
        self.calls = self.tokens = self.agree = 0
        self.worst = 0.0

    def __enter__(self):
        ex = importlib.import_module("deeplearning4j_tpu_torch.parallel.expert")
        self._ex, self._saved = ex, ex.moe_ffn
        fast, torch = ex.moe_ffn, self.torch

        def call(params, x, capacity_factor=1.25, token_mask=None):
            got = fast(params, x, capacity_factor, token_mask)
            with torch.no_grad():
                p = {k: v.detach() for k, v in params.items()}
                xd = x.detach()
                ref = ex.moe_ffn_reference(p, xd, capacity_factor, token_mask)
                scale = max(float(ref.abs().max()), 1e-30)
                rel = float((got.detach() - ref).abs().max()) / scale
                if rel > self.rel:
                    raise RuntimeError(f"moe_ffn {tuple(x.shape)}: {rel:.2e} "
                                       "of the dense plain result")
                e = int(p["router"].shape[1])
                cap = ex.moe_capacity(int(x.shape[0]), capacity_factor, e)
                slot, _, _ = ex.switch_route(xd @ p["router"], cap, token_mask)
                cpu_slot, _, _ = ex.switch_route(
                    xd.cpu() @ p["router"].cpu(), cap,
                    None if token_mask is None else token_mask.cpu())
            self.calls += 1
            self.worst = max(self.worst, rel)
            self.tokens += int(slot.numel())
            self.agree += int((slot.cpu() == cpu_slot).sum())
            return got

        ex.moe_ffn = call
        return self

    def __exit__(self, *exc):
        self._ex.moe_ffn = self._saved
        return False


class routing_log:
    """Within the block, each ``switch_route`` call's slots (a host
    copy) appended to ``slots``."""

    def __init__(self):
        self.slots = []

    def __enter__(self):
        ex = importlib.import_module("deeplearning4j_tpu_torch.parallel.expert")
        self._ex, self._saved = ex, ex.switch_route
        route = ex.switch_route

        def call(*args, **kw):
            out = route(*args, **kw)
            self.slots.append(out[0].cpu())
            return out

        ex.switch_route = call
        return self

    def __exit__(self, *exc):
        self._ex.switch_route = self._saved
        return False


def run_moe_transformer(torch, card, tokens):
    """[moe-transformer] the transformer LM of bench.py:866 (d 768, 12
    heads, vocab 256; 6 of its 12 layers) with a Switch MoE FFN of 4
    experts (hidden 3072, capacity factor 1.25: 8,192 tokens a block,
    2,560 slots an expert) in every block, Adam lr 3e-4, f32, 16 x 512 bytes of
    SURVEY.md: one step with every MoE call held against the dense plain
    version on the same operands and its routing against the CPU's; the
    main path's 20 steps (launches exact: a ``flash_attention`` a layer
    and 1 ``matmul_block`` a step); the default ``fit`` as one CUDA-graph
    chunk
    of 4 minibatches bitwise its per-step fit; ``output``; and sampling
    through ``rnn_time_step`` (a 256-byte prompt, then 32 bytes), each
    call's routing held against the CPU twin's and its probabilities
    where the routing agrees. Returns the launch counts."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch

    layers = MOE_LAYERS
    conf = moe_conf()
    net = per_step_loop(MultiLayerNetwork(conf, device="cuda").init())
    batches = char_batches(tokens, TX_BATCH, TX_T, MOE_STEPS, seed=45,
                           vocab=TX["vocab"])
    n_tok = TX_BATCH * TX_T
    cap = int(np.ceil(n_tok * 1.25 / MOE_EXPERTS))
    print(f"[moe-transformer] transformer_lm({dict(TX, n_layers=layers)}, "
          f"n_experts={MOE_EXPERTS}) "
          f"({net.num_params()} params), {n_tok} tokens a block, capacity "
          f"{cap} an expert, Adam, batch {TX_BATCH} x t {TX_T}, f32")
    main = {}
    held = held_moe(torch)
    with held:
        net.fit(batches[0])
        torch.cuda.synchronize()
    if held.calls != layers:
        raise RuntimeError(f"[moe-transformer] held {held.calls} MoE calls")
    agreement = held.agree / held.tokens
    if agreement < MOE_MIN_AGREEMENT:
        raise RuntimeError(f"[moe-transformer] card and CPU route "
                           f"{agreement:.4f} of tokens alike")
    # the main path: per-step fit, timed
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    scores = []
    t0 = time.perf_counter()
    for ds in batches:
        net.fit(ds)
        scores.append(net.score_value)
    wall = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    want = expected_counts(flash_attention=layers * MOE_STEPS,
                           matmul_block=MOE_STEPS)
    if launches != want:
        raise RuntimeError(f"[moe-transformer] {MOE_STEPS} steps launched "
                           f"{launches}, expected {want}")
    add_counts(main, launches)
    if not all(np.isfinite(scores)):
        raise RuntimeError(f"[moe-transformer] a score is not finite")
    peak = torch.cuda.max_memory_allocated()
    device_ms, top = profiled_device_ms(torch, lambda: net.fit(batches[:2]))
    device_ms /= 2
    ms = wall / MOE_STEPS * 1e3
    # the default fit: one CUDA-graph chunk, bitwise the per-step fit
    got, default = default_vs_per_step(
        torch, "moe-transformer default-fit",
        lambda p: MultiLayerNetwork(conf, device="cuda").init(params=p),
        char_batches(tokens, TX_BATCH, TX_T, MOE_DEFAULT_FIT_BATCHES,
                     seed=47, vocab=TX["vocab"]))
    add_counts(main, got)
    # output at t 512
    dispatch.reset_launch_counts()
    out = net.output(batches[0].features)
    torch.cuda.synchronize()
    per_output = dispatch.launch_counts()
    if per_output != expected_counts(flash_attention=layers,
                                     matmul_block=1):
        raise RuntimeError(f"[moe-transformer] output launched {per_output}")
    add_counts(main, per_output)
    if tuple(out.shape) != (TX_BATCH, TX["vocab"], TX_T) or not bool(
            torch.isfinite(out).all()):
        raise RuntimeError(f"[moe-transformer] bad output {tuple(out.shape)}")
    sample = sample_moe(torch, net, tokens)
    add_counts(main, sample.pop("launches"))
    res = {"steps": MOE_STEPS, "batch": TX_BATCH, "t": TX_T,
           "experts": MOE_EXPERTS, "capacity": cap,
           "tokens_per_s": MOE_STEPS * n_tok / wall,
           "host_ms_per_step": ms, "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / ms,
           "top_device_ms_per_step": {k[:60]: v / 2 for k, v in top.items()},
           "peak_memory_gb": peak / 1e9, "scores": scores,
           "launches_per_step": {k: v // MOE_STEPS for k, v in
                                 launches.items() if v},
           "moe_calls_held": held.calls,
           "moe_vs_dense_plain_max_rel_err": held.worst,
           "routing_agreement_card_vs_cpu": agreement,
           "default_fit": default, "sample": sample}
    print(f"[moe-transformer] {json.dumps(res)} card={card}")
    return main


def sample_moe(torch, model, tokens, seed=9):
    """KV-cache sampling of the MoE LM: a 256-byte prompt of SURVEY.md,
    then MOE_SAMPLE bytes drawn one at a time (seeded numpy). The CPU
    twin streams the same bytes; each call's routing (every block's
    slots) is compared, and where a call routes alike in every block
    its probabilities are held within 1e-3 of the largest. Each call
    takes a capacity of its own tokens (as in the JAX package), so the
    stream is not ``output``."""
    from deeplearning4j_tpu_torch.ops import dispatch

    vocab = TX["vocab"]
    rng = np.random.RandomState(seed)
    eye = np.eye(vocab, dtype=np.float32)
    start = rng.randint(0, len(tokens) - TX_PROMPT)
    fed = [int(i) for i in tokens[start:start + TX_PROMPT]]
    model.rnn_clear_previous_state()
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    probs = []
    card_log = routing_log()
    t0 = time.perf_counter()
    with card_log:
        out = model.rnn_time_step(np.ascontiguousarray(eye[fed].T[None]))
        probs.append(out[0].cpu())
        prompt_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for _ in range(MOE_SAMPLE):
            q = probs[-1][:, -1].double().numpy()
            fed.append(int(rng.choice(vocab, p=q / q.sum())))
            probs.append(model.rnn_time_step(eye[fed[-1]][None]).cpu()
                         .T)
        step_ms = (time.perf_counter() - t0) / MOE_SAMPLE * 1e3
    launches = dispatch.launch_counts()
    calls = 1 + MOE_SAMPLE
    if launches != expected_counts(matmul_block=calls):
        raise RuntimeError(f"[moe-transformer] sampling launched {launches}")
    model.rnn_clear_previous_state()
    twin = cpu_twin(torch, model)
    cpu_log = routing_log()
    with cpu_log:
        ref = [twin.rnn_time_step(np.ascontiguousarray(
            eye[fed[:TX_PROMPT]].T[None]))[0]]
        for b in fed[TX_PROMPT:]:
            ref.append(twin.rnn_time_step(eye[b][None]).T)
    layers = MOE_LAYERS
    if len(ref) != calls or len(cpu_log.slots) != len(card_log.slots):
        raise RuntimeError("[moe-transformer] the twin streamed "
                           f"{len(ref)} calls of {calls}")
    same_calls, tok, agree, err = 0, 0, 0, 0.0
    for i, (got, want) in enumerate(zip(probs, ref)):
        cs = card_log.slots[i * layers:(i + 1) * layers]
        rs = cpu_log.slots[i * layers:(i + 1) * layers]
        eq = [int((a == b).sum()) for a, b in zip(cs, rs)]
        tok += sum(int(a.numel()) for a in cs)
        agree += sum(eq)
        if all(e == a.numel() for e, a in zip(eq, cs)):
            same_calls += 1
            err = max(err, close_to_scale(torch, got, want, 1e-3))
    if agree / tok < MOE_MIN_AGREEMENT:
        raise RuntimeError(f"[moe-transformer] sampling routed "
                           f"{agree / tok:.4f} of tokens as the CPU did")
    return {"prompt": TX_PROMPT, "sampled": MOE_SAMPLE,
            "prompt_ms": prompt_ms, "ms_per_sampled_byte": step_ms,
            "routing_agreement": agree / tok,
            "calls_routed_alike": same_calls, "calls": calls,
            "max_abs_err_vs_cpu_where_routed_alike": err,
            "launches": launches}


def moe_step_reference(torch, ex, params, x, tgt, lr, aux_weight):
    """One SGD step of ``ExpertParallelMoE.train_step``'s loss through
    the single-device MoE (``moe_ffn``, the load-balancing loss on its
    router logits): (new parameters, loss)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in
         params.items()}
    y, aux = ex.moe_ffn(p, x, 1.25, with_aux=True)
    n, d = int(x.shape[0]), int(x.shape[1])
    loss = ((y - tgt) ** 2).sum() / (n * d) + aux_weight * aux / 1
    loss.backward()
    return ({k: (v - (lr * v.grad).to(v.dtype)).detach()
             for k, v in p.items()}, loss.detach())


def run_moe_ep(torch, card):
    """[moe-ep] ``ExpertParallelMoE`` over an NCCL world of one, formed
    through a file rendezvous in a temporary directory, at the MoE LM's
    block shapes (8,192 tokens of d 768, 4 experts of hidden 3072,
    capacity 2,560; weights from a seed):
    ``apply`` bitwise the single-device MoE, two SGD ``train_step``s
    bitwise the single-device step (both exchanges and the router's
    all-reduce through NCCL), and the times of both beside the single
    device's. Returns launch counts (the MoE launches no kernel of its
    own: all zero)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.parallel import (
        init_distributed,
        shutdown_distributed,
    )

    ex = importlib.import_module("deeplearning4j_tpu_torch.parallel.expert")
    d, h = TX["d_model"], 4 * TX["d_model"]
    n = TX_BATCH * TX_T
    gen = torch.Generator().manual_seed(61)
    params = {k: v.cuda() for k, v in ex.init_moe_params(
        gen, d, h, MOE_EXPERTS).items()}
    x = torch.randn((n, d), generator=gen).cuda()
    tgt = (0.1 * torch.randn((n, d), generator=gen)).cuda()
    tmp = tempfile.mkdtemp(prefix="dl4j_rdv_")
    dispatch.reset_launch_counts()
    try:
        init_distributed(f"file://{tmp}/rdv", 1, 0, device="cuda",
                         timeout_s=120)
        mesh = ex.build_expert_mesh()
        if dist.get_backend() != "nccl" or mesh.backend != "nccl":
            raise RuntimeError(f"[moe-ep] formed {dist.get_backend()}")
        ep = ex.ExpertParallelMoE(mesh, n_experts=MOE_EXPERTS)
        mine = ep.shard_params(params)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            single = ex.moe_ffn(params, x, 1.25)
        got = ep.apply(mine, x)
        torch.cuda.synchronize()
        if not torch.equal(got, single):
            raise RuntimeError("[moe-ep] the world of one differs from the "
                               "single-device MoE: "
                               f"{float((got - single).abs().max())}")
        p_ep, p_one = mine, params
        losses = []
        for _ in range(2):
            p_ep, l_ep = ep.train_step(p_ep, x, tgt, lr=0.05,
                                       aux_weight=0.01)
            p_one, l_one = moe_step_reference(torch, ex, p_one, x, tgt,
                                              0.05, 0.01)
            losses.append((float(l_ep), float(l_one)))
            if not torch.equal(l_ep, l_one) or not all(
                    torch.equal(p_ep[k], p_one[k]) for k in p_one):
                raise RuntimeError("[moe-ep] a train_step differs from the "
                                   "single-device step")
        peak = torch.cuda.max_memory_allocated()
        apply_ms, apply_host = events_ms(torch, lambda: ep.apply(mine, x),
                                         reps=10)
        one_ms, one_host = events_ms(
            torch, lambda: ex.moe_ffn(params, x, 1.25), reps=10)
        t0 = time.perf_counter()
        for _ in range(4):
            p_ep, _ = ep.train_step(p_ep, x, tgt, lr=0.05)
        torch.cuda.synchronize()
        step_host = (time.perf_counter() - t0) / 4 * 1e3
        step_ms, _ = events_ms(
            torch, lambda: ep.train_step(p_ep, x, tgt, lr=0.05), reps=4)
    finally:
        shutdown_distributed()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dispatch.launch_counts()
    res = {"world": 1, "backend": "nccl", "tokens": n, "d": d, "hidden": h,
           "experts": MOE_EXPERTS,
           "capacity": ex.moe_capacity(n, 1.25, MOE_EXPERTS),
           "apply_bitwise_single_device": True,
           "train_steps_bitwise_single_device": 2, "losses": losses,
           "apply_device_ms": apply_ms, "apply_host_ms": apply_host,
           "single_device_ms": one_ms, "single_device_host_ms": one_host,
           "train_step_device_ms": step_ms,
           "train_step_host_ms": step_host,
           "train_step_busy_share": step_ms / step_host,
           "tokens_per_s": n / step_host * 1e3,
           "peak_memory_gb": peak / 1e9}
    print(f"[moe-ep] {json.dumps(res)} card={card}")
    return launches


def graph_charrnn_conf(peephole: bool):
    """BASELINE.json config #3 (GravesLSTM x 2, hidden 200, vocab 77,
    TBPTT 50, RMSPROP lr 0.1) built as a ComputationGraph: vertices l0,
    l1, out."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer

    return (NeuralNetConfiguration.Builder().seed(42).learning_rate(0.1)
            .updater("RMSPROP").graph_builder().add_inputs("in")
            .add_layer("l0", GravesLSTM(n_in=CHAR_VOCAB, n_out=CHAR_HIDDEN,
                                        activation="tanh", peephole=peephole),
                       "in")
            .add_layer("l1", GravesLSTM(n_in=CHAR_HIDDEN, n_out=CHAR_HIDDEN,
                                        activation="tanh", peephole=peephole),
                       "l0")
            .add_layer("out", RnnOutputLayer(n_in=CHAR_HIDDEN,
                                             n_out=CHAR_VOCAB,
                                             loss="MCXENT"), "l1")
            .set_outputs("out")
            .backprop_type("TruncatedBPTT")
            .t_bptt_forward_length(CHAR_TBPTT)
            .t_bptt_backward_length(CHAR_TBPTT).build())


def run_graph_charrnn(torch, card, ids):
    """[graph-charrnn] the char-RNN as a ComputationGraph (graph
    truncated BPTT and ``rnn_time_step``), with peepholes (``lstm_cell``)
    and without (``lstm_seq_fwd`` / ``lstm_seq_bwd``): 2 minibatches of
    32 x 200 characters of SURVEY.md (4 TBPTT segments) beside the
    ``MultiLayerNetwork`` char-RNN on the same weights and data, scores
    and parameters within kernel_tols (rtol 2e-4, atol 2e-5; bitwise
    noted), launches exact, ``output`` and 200 characters sampled
    through the graph's ``rnn_time_step`` held against the network's.
    Returns the graph's launch counts (the main path)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch

    chunks = CHAR_SEGMENT // CHAR_TBPTT
    batches = char_batches(ids, CHAR_BATCH, CHAR_SEGMENT,
                           GRAPH_CHAR_MINIBATCHES, seed=71)
    names = ("l0", "l1", "out")
    main = {}
    for peephole in (True, False):
        tag = "graph-charrnn" + ("" if peephole else "-seq")
        g = per_step_loop(ComputationGraph(graph_charrnn_conf(peephole),
                                           device="cuda").init())
        net = per_step_loop(MultiLayerNetwork(charrnn_conf(peephole),
                                              device="cuda").init(params={
            str(i): {k: t.clone() for k, t in g.params[n].items()}
            for i, n in enumerate(names)}))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        g_scores, n_scores, wall = [], [], 0.0
        dispatch.reset_launch_counts()
        for ds in batches:
            t0 = time.perf_counter()
            g.fit(ds)
            g_scores.append(g.score_value)
            wall += time.perf_counter() - t0
        fit_counts = dispatch.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for ds in batches:
            net.fit(ds)
            n_scores.append(net.score_value)
        np.testing.assert_allclose(g_scores, n_scores, rtol=2e-4, atol=2e-5)
        bitwise = True
        for i, n in enumerate(names):
            for k, t in g.params[n].items():
                ref = net.params[str(i)][k]
                torch.testing.assert_close(t, ref, rtol=2e-4, atol=2e-5)
                bitwise = bitwise and torch.equal(t, ref)
        steps = 2 * CHAR_TBPTT * chunks * GRAPH_CHAR_MINIBATCHES
        segs = chunks * GRAPH_CHAR_MINIBATCHES
        want = (expected_counts(lstm_cell=steps) if peephole else
                expected_counts(lstm_seq_fwd=2 * segs, lstm_seq_bwd=2 * segs))
        if fit_counts != want:
            raise RuntimeError(f"[{tag}] fit launched {fit_counts}, "
                               f"expected {want}")
        if g.iteration_count != segs:
            raise RuntimeError(f"[{tag}] {g.iteration_count} steps")
        seg = batches[0].features[:4]
        dispatch.reset_launch_counts()
        out = g.output(seg)[0]
        # 200 characters through the graph's rnn_time_step, the network
        # streaming the same ones after
        rng = np.random.RandomState(7)
        eye = np.eye(CHAR_VOCAB, dtype=np.float32)
        g.rnn_clear_previous_state()
        net.rnn_clear_previous_state()
        fed = [int(rng.randint(0, CHAR_VOCAB - 1))]
        t0 = time.perf_counter()
        stream = []
        for _ in range(CHAR_SAMPLE):
            p = g.rnn_time_step(eye[fed[-1]][None])[0][0]
            stream.append(p)
            q = p.double().cpu().numpy()
            fed.append(int(rng.choice(CHAR_VOCAB, p=q / q.sum())))
        sample_ms = (time.perf_counter() - t0) / CHAR_SAMPLE * 1e3
        stream_counts = dispatch.launch_counts()
        out_err = close_to_scale(torch, out, net.output(seg), 1e-4)
        ref_stream = [net.rnn_time_step(eye[c][None])[0]
                      for c in fed[:-1]]
        sample_err = close_to_scale(torch, torch.stack(stream),
                                    torch.stack(ref_stream), 1e-4)
        g.rnn_clear_previous_state()
        per_call = ({"lstm_cell": 2} if peephole else {"lstm_seq_fwd": 2})
        want_stream = expected_counts(**{
            k: v * (CHAR_SAMPLE + (CHAR_SEGMENT if k == "lstm_cell" else 1))
            for k, v in per_call.items()})
        if stream_counts != want_stream:
            raise RuntimeError(f"[{tag}] output and sampling launched "
                               f"{stream_counts}, expected {want_stream}")
        add_counts(main, fit_counts)
        add_counts(main, stream_counts)
        device_ms, _ = profiled_device_ms(torch, lambda: g.fit(batches[0]))
        device_ms /= chunks
        ms = wall / segs * 1e3
        res = {"peephole": peephole, "minibatches": GRAPH_CHAR_MINIBATCHES,
               "segments": segs,
               "chars_per_s": GRAPH_CHAR_MINIBATCHES * CHAR_BATCH
               * CHAR_SEGMENT / wall,
               "host_ms_per_segment": ms, "device_ms_per_segment": device_ms,
               "device_busy_share": device_ms / ms,
               "peak_memory_gb": peak / 1e9,
               "scores": g_scores, "multilayer_scores": n_scores,
               "bitwise_multilayer": bitwise,
               "output_max_abs_err_vs_multilayer": out_err,
               "ms_per_sampled_char": sample_ms,
               "sample_max_abs_err_vs_multilayer": sample_err,
               "launches": {k: v for k, v in add_counts(
                   dict(fit_counts), stream_counts).items() if v},
               "sample_ids_head": fed[:20]}
        print(f"[{tag}] {json.dumps(res)} card={card}")
        del g, net
    return main


def conv_lstm_conf(t=CONV_LSTM_T):
    """LeNet-5's two conv stages over each 28 x 28 frame of a sequence
    (``RnnToCnn`` on the input, ``CnnToRnn`` inferred), GravesLSTM 200,
    then a softmax of 10 on every frame (``RnnToFeedForward``
    inferred); Adam lr 0.01 as the zoo's LeNet."""
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
        RnnToCnnPreProcessor,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer,
        GravesLSTM,
        OutputLayer,
        SubsamplingLayer,
    )

    return (NeuralNetConfiguration.Builder().seed(42).learning_rate(0.01)
            .updater("ADAM").list()
            .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(pooling_type="MAX"))
            .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(pooling_type="MAX"))
            .layer(GravesLSTM(n_out=CHAR_HIDDEN, activation="tanh"))
            .layer(OutputLayer(n_out=10, loss="MCXENT"))
            .input_pre_processor(0, RnnToCnnPreProcessor(28, 28, 1))
            .set_input_type(InputType.recurrent(784, t))
            .build())


def conv_lstm_shapes(batch=CONV_LSTM_BATCH * CONV_LSTM_T):
    """The distinct conv kernel shapes of one conv -> LSTM step over
    ``batch`` frames."""
    return distinct_shapes(step_shapes(kernel_shapes(conv_lstm_conf(),
                                                     batch)))


def conv_lstm_batches(n, batch, seed):
    """Sequences of CONV_LSTM_T synthetic MNIST digits (the iterator's
    seeded digits): features [batch, 784, t], one label row a frame in
    RnnToFeedForward's order (example-major, time within)."""
    import warnings

    from deeplearning4j_tpu_torch.datasets import DataSet, MnistDataSetIterator

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        it = MnistDataSetIterator(batch * CONV_LSTM_T, allow_synthetic=True,
                                  num_examples=n * batch * CONV_LSTM_T,
                                  seed=seed)
        digits = list(it)
    out = []
    for ds in digits:
        f = np.asarray(ds.features, np.float32).reshape(batch, CONV_LSTM_T,
                                                        784)
        out.append(DataSet(np.ascontiguousarray(f.transpose(0, 2, 1)),
                           np.asarray(ds.labels, np.float32)))
    return out


def run_conv_lstm(torch, card):
    """[conv-lstm] ``conv_lstm_conf``: 32 sequences of 16 frames (512
    frames a step through LeNet's convs, the LSTM at b 32, n 200): one
    step at 2 sequences against the CPU twin with every conv kernel call
    held on its operands, one step's launches exact, then 16 steps of
    ``fit`` (the main path) and ``output`` on a held-out minibatch. Returns the main path's
    launch counts."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch

    conf = conv_lstm_conf()
    net = per_step_loop(MultiLayerNetwork(conf, device="cuda").init())
    init = {ln: {pn: t.clone() for pn, t in lp.items()}
            for ln, lp in net.params.items()}
    kinds = [type(p).__name__ for _, p in sorted(conf.preprocessors.items())]
    print(f"[conv-lstm] RnnToCnn -> conv 5x5 20 -> pool -> conv 5x5 50 -> "
          f"pool -> GravesLSTM {CHAR_HIDDEN} -> softmax 10 "
          f"({net.num_params()} params; preprocessors {kinds}), "
          f"{CONV_LSTM_BATCH} sequences x {CONV_LSTM_T} frames, Adam")
    if kinds != ["RnnToCnnPreProcessor", "CnnToRnnPreProcessor",
                 "RnnToFeedForwardPreProcessor"]:
        raise RuntimeError(f"[conv-lstm] preprocessors {kinds}")
    batches = conv_lstm_batches(CONV_LSTM_STEPS + 1, CONV_LSTM_BATCH, seed=3)
    # one step at 2 sequences, card and CPU twin from the same weights:
    # Adam moves a weight by about lr whatever its gradient's size, so
    # every weight within 3 lr and at most 1 % of a parameter's entries
    # beyond 1e-4 + 1e-3 |w|
    small = type(batches[0])(
        batches[0].features[:CONV_LSTM_TWIN_BATCH],
        batches[0].labels[:CONV_LSTM_TWIN_BATCH * CONV_LSTM_T])
    a = per_step_loop(MultiLayerNetwork(conf, device="cuda").init(
        params=init))
    twin = cpu_twin(torch, a)
    out_err = close_to_scale(torch, a.output(small.features).cpu(),
                             twin.output(small.features), 1e-4)
    held = held_on_operands()
    with held:
        a.fit(small)
    twin.fit(small)
    np.testing.assert_allclose(a.score_value, twin.score_value, rtol=1e-4)
    max_off = 0.0
    for ln, lp in twin.params.items():
        for pn, ref in lp.items():
            dlt = (a.params[ln][pn].cpu() - ref).abs()
            off = float((dlt > 1e-4 + 1e-3 * ref.abs()).float().mean())
            max_off = max(max_off, off)
            if float(dlt.max()) > 3 * 0.01 or off > 0.01:
                raise RuntimeError(f"[conv-lstm] card and CPU differ at "
                                   f"{ln}/{pn}: {float(dlt.max())}, {off}")
    if {k: n for k, (n, _) in held.errors.items()} != {
            "conv_block": 4, "conv_bwd_data": 1, "conv_bwd_w": 2}:
        raise RuntimeError(f"[conv-lstm] held calls: {held.errors}")
    del a, twin
    dispatch.reset_launch_counts()
    net.fit(batches[-1])
    torch.cuda.synchronize()
    per_step = dispatch.launch_counts()
    want = expected_counts(conv_block=4, conv_bwd_data=1, conv_bwd_w=2,
                           lstm_cell=CONV_LSTM_T)
    if per_step != want:
        raise RuntimeError(f"[conv-lstm] one step launched {per_step}, "
                           f"expected {want}")
    model = per_step_loop(MultiLayerNetwork(conf, device="cuda").init(
        params=init))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    scores = []
    t0 = time.perf_counter()
    for ds in batches[:CONV_LSTM_STEPS]:
        model.fit(ds)
        scores.append(model.score_value)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    out = model.output(batches[-1].features)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    want = {k: v * CONV_LSTM_STEPS for k, v in per_step.items()}
    add_counts(want, {"conv_block": 2, "lstm_cell": CONV_LSTM_T})
    if launches != want:
        raise RuntimeError(f"[conv-lstm] the main path launched {launches}, "
                           f"expected {want}")
    if tuple(out.shape) != (CONV_LSTM_BATCH * CONV_LSTM_T, 10) or not bool(
            torch.isfinite(out).all()):
        raise RuntimeError(f"[conv-lstm] bad output {tuple(out.shape)}")
    # Adam at lr 0.01 leaps over the first steps (a fresh 200-unit LSTM
    # under the softmax): held to the mean of the last four
    if not all(np.isfinite(scores)) or not np.mean(scores[-4:]) < scores[0]:
        raise RuntimeError(f"[conv-lstm] the score did not fall: {scores}")
    accuracy = float((out.argmax(1).cpu().numpy()
                      == batches[-1].labels.argmax(1)).mean())
    device_ms, top = profiled_device_ms(torch,
                                        lambda: model.fit(batches[0]))
    ms = wall / CONV_LSTM_STEPS * 1e3
    res = {"steps": CONV_LSTM_STEPS, "sequences": CONV_LSTM_BATCH,
           "frames_per_s": CONV_LSTM_STEPS * CONV_LSTM_BATCH * CONV_LSTM_T
           / wall,
           "host_ms_per_step": ms, "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / ms,
           "top_device_ms_per_step": {k[:60]: v for k, v in top.items()},
           "peak_memory_gb": peak / 1e9, "scores": scores,
           "held_out_accuracy": accuracy,
           "launches_per_step": {k: v for k, v in per_step.items() if v},
           "twin_output_max_abs_err": out_err,
           "twin_max_share_off": max_off,
           "kernels_on_operands_max_rel_err": {
               k: e for k, (_, e) in held.errors.items()}}
    print(f"[conv-lstm] {json.dumps(res)} card={card}")
    return launches


# -- the distribution slice's last raises: tensor, sequence and pipeline
# parallelism on one spawned gloo world of two ranks on the card, and the
# cluster master in this process

TP_MODEL = 2              # [alexnet-tp]: build_mesh(data=1, model=2)
TP_STEPS = 4
RING_SEQ = 2              # [ring-attention]: build_seq_mesh(data=1, seq=2)
RING_T = TX_LONG_T        # 16,384 bytes, 8,192 a rank
RING_REL = 1e-3           # of the reference's largest entry
GPIPE_STAGES = 2
GPIPE_D = 4096            # AlexNet's fc7: 4096 -> 4096
GPIPE_BATCH = 128
GPIPE_MICRO = 4
GPIPE_LR = 0.01
GPIPE_REL = 1e-4          # of the reference's largest entry (or move)
CLUSTER_WORKERS = 4
CLUSTER_BATCH = 64
CLUSTER_MINIBATCHES = 16
CLUSTER_HOLDOUT = 4
CLUSTER_ES_EPOCHS = 3
CLUSTER_SHARE = 0.05      # of a weight's 4-step move
TP_SCORE_RTOL = 1e-4      # [alexnet-tp]'s scores against the world of one
TP_SHARE = 0.1            # of a weight's 4-step move
WORLD_PHASES = ("alexnet-tp", "ring-attention", "gpipe")
WORLD_TIMEOUT_S = 600


def alexnet_tp_shapes(batch=ALEXNET_TRAIN_BATCH, model=TP_MODEL):
    """The distinct kernel shapes of one tensor-parallel AlexNet step on
    one of ``model`` ranks: each conv at its rank's out-channels (48 /
    128 / 192 / 192 / 128), each dense layer at its rank's columns, and
    the softmax head's product at its 500 columns with the identity
    epilogue (its softmax follows the gather)."""
    from deeplearning4j_tpu_torch.zoo import alexnet

    conf = alexnet()
    shards = []
    for name, kind, geo in kernel_shapes(conf, batch):
        geo = dict(geo)
        if kind == "conv_block":
            geo["w"] = (geo["w"][0] // model,) + tuple(geo["w"][1:])
        else:
            geo["n"] //= model
        shards.append((name, kind, geo))
    head = conf.layers[-1]
    shards.append(("output", "matmul_block", dict(
        m=batch, k=head.n_in, n=head.n_out // model, activation="identity")))
    return distinct_shapes(step_shapes(shards))


def shard_records(torch, F, records, model, shapes, gen):
    """``[kernel]`` records of ``shapes`` (distinct_shapes' tuples) at
    KERNEL_WINDOW_MS, each with its launches a step, appended and
    printed."""
    for name, kind_, geo, names in shapes:
        if kind_.startswith("conv_bwd"):
            rec = check_bwd_kernel(torch, model, name, kind_, geo, gen,
                                   KERNEL_WINDOW_MS)
        else:
            rec = check_kernel(torch, F, model, name, kind_, geo, gen,
                               KERNEL_WINDOW_MS)
        rec.update(vertices=names, launches_per_step=len(names) * (
            2 if kind_ == "conv_block" else 1))
        records.append(rec)
        print(f"[kernel] {json.dumps(rec)}")


def tp_batches(torch):
    """[alexnet-train]'s two minibatches of standardized pixels, on the
    card."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    return [DataSet(torch.from_numpy((b.features.astype(np.float32) - 127.5)
                                     / 73.9).cuda(),
                    torch.from_numpy(b.labels.astype(np.float32)).cuda())
            for b in resnet_batches(2, ALEXNET_TRAIN_BATCH, seed=13)]


def ring_blocks():
    """The transformer LM's 12 blocks with the ring over a seq axis of
    RING_SEQ ranks, and its head."""
    import dataclasses

    conf = tx_conf()
    blocks = [dataclasses.replace(layer, seq_axis="seq",
                                  seq_axis_size=RING_SEQ)
              for layer in conf.layers[2:2 + TX["n_layers"]]]
    return blocks, conf.layers[-1]


def next_byte_loss(torch, head, head_params, h, labels, count):
    """The next-byte MCXENT of the head on ``h`` ([b, d, t]) summed over
    its positions and divided by ``count`` (all ranks' positions)."""
    logits = head.pre_output(head_params, h)
    return -(labels * torch.log_softmax(logits, dim=1)).sum() / count


def load_tree(torch, path, prefix=""):
    """``{layer: {param: tensor on the card}}`` of an ``.npz`` keyed
    ``layer/param``."""
    tree = {}
    with np.load(path) as z:
        for k in z.files:
            if k.startswith(prefix):
                ln, pn = k[len(prefix):].split("/")
                tree.setdefault(ln, {})[pn] = torch.from_numpy(z[k]).cuda()
    return tree


def rank_alexnet_tp(torch, rank, spec):
    """One rank of [alexnet-tp]: the zoo's AlexNet from its seed under
    ``DistributedTrainer(build_mesh(data=1, model=2),
    tensor_parallel=True)``, TP_STEPS steps over [alexnet-train]'s two
    minibatches; the scores, launches, host and event ms of each step,
    the gathered weights (rank 0 writes them) and the device ms of one
    more step."""
    from deeplearning4j_tpu_torch.nn import core
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.parallel import (
        DistributedTrainer,
        build_mesh,
    )
    from deeplearning4j_tpu_torch.zoo import alexnet

    net = per_step_loop(MultiLayerNetwork(alexnet(), device="cuda").init())
    tr = DistributedTrainer(net, mesh=build_mesh(data=1, model=TP_MODEL),
                            tensor_parallel=True)
    shapes = {f"{ln}/{pn}": list(t.shape) for ln, lp in net.params.items()
              for pn, t in lp.items()}
    batches = tp_batches(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    scores, host_ms, event_ms = [], [], []
    for i in range(TP_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        score = tr.fit_minibatch(batches[i % len(batches)])
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
        scores.append(float(score))
    launches = dispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    params, _ = core.canonical_trees(net)
    if rank == 0:
        np.savez(spec["alexnet_tp_out"], **{
            f"{ln}/{pn}": t.cpu().numpy() for ln, lp in params.items()
            for pn, t in lp.items()})
    del params
    device_ms, top = profiled_device_ms(
        torch, lambda: tr.fit_minibatch(batches[0]))
    return {"scores": scores, "launches": launches, "host_ms": host_ms,
            "event_ms": event_ms, "device_ms_one_step": device_ms,
            "top_device_ms": {k[:60]: v for k, v in top.items()},
            "shapes": shapes, "peak_gb": peak / 1e9}


def rank_ring(torch, rank, spec):
    """One rank of [ring-attention]: the LM's 12 trained blocks as
    ``TransformerBlock(seq_axis="seq", seq_axis_size=2)`` over
    ``build_seq_mesh(data=1, seq=2)``. Forward (no grad) of this rank's
    8,192 of the 16,384 positions, held against the unsharded blocks'
    output on them; one backward of the next-byte loss at 16 x 512, this
    rank's 256 positions, the blocks' and the head's gradients summed
    over the ranks and held (rank 0) against the unsharded ones."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.parallel.sequence import build_seq_mesh

    build_seq_mesh(data=1, seq=RING_SEQ)
    blocks, head = ring_blocks()
    params = load_tree(torch, spec["ring_params"])
    names = [str(2 + i) for i in range(len(blocks))]
    head_name = str(2 + len(blocks))
    dispatch.reset_launch_counts()
    with np.load(spec["ring_fwd"]) as z:
        tl = z["h"].shape[2] // RING_SEQ
        cols = slice(rank * tl, (rank + 1) * tl)
        x = torch.from_numpy(np.ascontiguousarray(z["h"][:, :, cols])).cuda()
        ref = torch.from_numpy(np.ascontiguousarray(z["y"][:, :, cols]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        for blk, n in zip(blocks, names):
            x, _ = blk.apply(params[n], x, {})
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_peak = torch.cuda.max_memory_allocated()
    got = x.cpu()
    del x
    fwd_err = float((got - ref).abs().max())
    fwd_scale = float(ref.abs().max())
    fwd_launches = dispatch.launch_counts()
    # the backward at 16 x 512, this rank's 256 positions
    with np.load(spec["ring_bwd"]) as z:
        tl = z["h"].shape[2] // RING_SEQ
        cols = slice(rank * tl, (rank + 1) * tl)
        h = torch.from_numpy(np.ascontiguousarray(z["h"][:, :, cols])).cuda()
        lab = torch.from_numpy(np.ascontiguousarray(
            z["labels"][:, :, cols])).cuda()
        count = float(z["labels"].shape[0] * z["labels"].shape[2])
    leaves = {n: {pn: t.requires_grad_() for pn, t in params[n].items()}
              for n in names + [head_name]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = h
    for blk, n in zip(blocks, names):
        x, _ = blk.apply(leaves[n], x, {})
    loss = next_byte_loss(torch, head, leaves[head_name], x, lab, count)
    loss.backward()
    torch.cuda.synchronize()
    bwd_ms = (time.perf_counter() - t0) * 1e3
    launches = dispatch.launch_counts()
    total = loss.detach().reshape(1).clone()
    dist.all_reduce(total)
    errs = {}
    grads = {n: {pn: t.grad for pn, t in lp.items()}
             for n, lp in leaves.items()}
    for n, lp in grads.items():
        for pn, g in lp.items():
            dist.all_reduce(g)  # the weights are replicated over the ring
    if rank == 0:
        with np.load(spec["ring_grads"]) as z:
            for k in z.files:
                ln, pn = k.split("/")
                want = torch.from_numpy(z[k])
                err = float((grads[ln][pn].cpu() - want).abs().max())
                errs[k] = [err, float(want.abs().max())]
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_err": fwd_err,
            "fwd_scale": fwd_scale, "loss": float(total[0]),
            "grad_errs": errs, "launches": launches,
            "fwd_launches": fwd_launches, "fwd_peak_gb": fwd_peak / 1e9,
            "positions_fwd": RING_T // RING_SEQ}


def gpipe_stage(params, x):
    """[gpipe]'s stage: the dense kernel with its relu epilogue."""
    from deeplearning4j_tpu_torch.ops import matmul_block

    return matmul_block(x, params["w"], params["b"], activation="relu")


def mse(torch, out, y):
    return torch.mean((out - y) ** 2)


def rank_gpipe(torch, rank, spec):
    """One rank of [gpipe]: ``GPipe(build_pipe_mesh(2), gpipe_stage,
    n_micro=4)`` on batch 128: ``apply`` and two ``train_step``s (MSE,
    SGD), each held against the serial composition in one process
    (``spec["gpipe"]``: its output, losses and weights)."""
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        GPipe,
        build_pipe_mesh,
    )

    pipe = GPipe(build_pipe_mesh(GPIPE_STAGES), gpipe_stage,
                 n_micro=GPIPE_MICRO)
    z = dict(np.load(spec["gpipe"]))
    params = pipe.shard_params({"w": z["w"], "b": z["b"]}, device="cuda")
    x = torch.from_numpy(z["x"]).cuda()
    y = torch.from_numpy(z["y"]).cuda()
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe.apply(params, x)
    torch.cuda.synchronize()
    apply_ms = (time.perf_counter() - t0) * 1e3
    q, losses, step_ms = params, [], []
    for _ in range(2):
        t0 = time.perf_counter()
        q, loss = pipe.train_step(q, x, y, lambda o, t: mse(torch, o, t),
                                  lr=GPIPE_LR)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = dispatch.launch_counts()
    s = rank
    move = {k: z[f"ref_{k}"][s] - z[k][s] for k in ("w", "b")}
    return {"apply_ms": apply_ms, "step_ms": step_ms, "losses": losses,
            "ref_losses": z["ref_losses"].tolist(),
            "out_err": float(np.abs(out.cpu().numpy() - z["ref_out"]).max()),
            "out_scale": float(np.abs(z["ref_out"]).max()),
            "param_errs": {k: [float(np.abs(q[k].cpu().numpy()
                                            - z[f"ref_{k}"][s]).max()),
                               float(np.abs(move[k]).max())]
                           for k in ("w", "b")},
            "launches": launches}


RANK_PHASES = {"alexnet-tp": rank_alexnet_tp, "ring-attention": rank_ring,
               "gpipe": rank_gpipe}

_WORLD_RANK = r"""
import json, sys, time
import torch
import chip_smoke as cs
from deeplearning4j_tpu_torch.parallel import (
    init_distributed, shutdown_distributed)

spec = json.loads(sys.argv[1])
rank = spec["rank"]
# gloo: two ranks on one card (NCCL refuses two ranks a device); NCCL:
# a card a rank (scripts/torch_parallel_nccl.py)
init_distributed("file://" + spec["rdv"], 2, rank, device="cuda",
                 backend=spec.get("backend", "gloo"), timeout_s=120)
out = {}
for tag in spec["phases"]:
    t0 = time.perf_counter()
    out[tag] = cs.RANK_PHASES[tag](torch, rank, spec)
    out[tag]["rank_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
with open(spec["out"], "w") as fh:
    json.dump(out, fh)
shutdown_distributed()
"""


def world_inputs(torch, lm, tokens, tags, tmp):
    """What the world's phases read, made in this process: [alexnet-tp]'s
    world of one (TP_STEPS steps from the same seed: its weights before
    and after, its scores), [ring-attention]'s trained blocks, the states
    entering block 1 at 16,384 bytes and at 16 x 512 with the unsharded
    blocks' output and gradients, and [gpipe]'s weights, batch and the
    serial composition's output, losses and weights."""
    import os

    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import alexnet

    f = os.path.join
    spec, ref = {}, {}
    if "alexnet-tp" in tags:
        net = per_step_loop(MultiLayerNetwork(alexnet(),
                                              device="cuda").init())
        ref["before"] = {ln: {pn: t.cpu() for pn, t in lp.items()}
                         for ln, lp in net.params.items()}
        batches = tp_batches(torch)
        ref["scores"] = [float(net.fit_minibatch(batches[i % 2]))
                         for i in range(TP_STEPS)]
        ref["after"] = {ln: {pn: t.cpu() for pn, t in lp.items()}
                        for ln, lp in net.params.items()}
        del net, batches
        spec["alexnet_tp_out"] = f(tmp, "alexnet_tp.npz")
    if "ring-attention" in tags:
        blocks, head = ring_blocks()
        names = [str(2 + i) for i in range(len(blocks) + 1)]
        np.savez(f(tmp, "ring_params.npz"), **{
            f"{n}/{pn}": t.detach().cpu().numpy() for n in names
            for pn, t in lm.params[n].items()})
        # 16,384 bytes: the states entering block 1 and leaving block 12
        x = char_batches(tokens, 1, RING_T, 1, seed=11,
                         vocab=TX["vocab"])[0].features
        with torch.no_grad():
            acts = lm.feed_forward(x)
        np.savez(f(tmp, "ring_fwd.npz"), h=acts[1].cpu().numpy(),
                 y=acts[1 + len(blocks)].cpu().numpy())
        del acts
        # 16 x 512: the next-byte loss's gradients of the unsharded blocks
        ds = char_batches(tokens, TX_BATCH, TX_T, 1, seed=12,
                          vocab=TX["vocab"])[0]
        # (a clone: an inference-mode tensor cannot enter a backward)
        h = lm.feed_forward(ds.features)[1].clone()
        plain = [unsharded(b) for b in blocks]
        leaves = {n: {pn: t.detach().clone().requires_grad_()
                      for pn, t in lm.params[n].items()} for n in names}
        xh = h
        for blk, n in zip(plain, names):
            xh, _ = blk.apply(leaves[n], xh, {})
        lab = torch.as_tensor(ds.labels, dtype=torch.float32).cuda()
        loss = next_byte_loss(torch, head, leaves[names[-1]], xh, lab,
                              float(lab.shape[0] * lab.shape[2]))
        loss.backward()
        np.savez(f(tmp, "ring_bwd.npz"), h=h.cpu().numpy(),
                 labels=lab.cpu().numpy())
        np.savez(f(tmp, "ring_grads.npz"), **{
            f"{n}/{pn}": t.grad.cpu().numpy() for n, lp in leaves.items()
            for pn, t in lp.items()})
        ref["ring_loss"] = float(loss.detach())
        del leaves, xh, h
        spec.update(ring_params=f(tmp, "ring_params.npz"),
                    ring_fwd=f(tmp, "ring_fwd.npz"),
                    ring_bwd=f(tmp, "ring_bwd.npz"),
                    ring_grads=f(tmp, "ring_grads.npz"))
    if "gpipe" in tags:
        rng = np.random.RandomState(21)
        d = GPIPE_D
        z = {"w": (rng.randn(GPIPE_STAGES, d, d) / np.sqrt(d)).astype(
                 np.float32),
             "b": (0.1 * rng.randn(GPIPE_STAGES, d)).astype(np.float32),
             "x": rng.randn(GPIPE_BATCH, d).astype(np.float32),
             "y": rng.rand(GPIPE_BATCH, d).astype(np.float32)}
        # the serial composition of the stages in this process
        p = [{k: torch.from_numpy(z[k][s]).cuda() for k in ("w", "b")}
             for s in range(GPIPE_STAGES)]
        x, y = torch.from_numpy(z["x"]).cuda(), torch.from_numpy(z["y"]).cuda()

        def serial(ps):
            h = x
            for q in ps:
                h = gpipe_stage(q, h)
            return h
        with torch.no_grad():
            z["ref_out"] = serial(p).cpu().numpy()
        losses = []
        for _ in range(2):
            leaves = [{k: t.detach().requires_grad_() for k, t in q.items()}
                      for q in p]
            loss = mse(torch, serial(leaves), y)
            grads = torch.autograd.grad(loss, [t for q in leaves
                                               for t in q.values()])
            it = iter(grads)
            p = [{k: (t - GPIPE_LR * next(it)).detach() for k, t in q.items()}
                 for q in leaves]
            losses.append(float(loss.detach()))
        z["ref_losses"] = np.asarray(losses)
        for k in ("w", "b"):
            z[f"ref_{k}"] = np.stack([q[k].cpu().numpy() for q in p])
        np.savez(f(tmp, "gpipe.npz"), **z)
        spec["gpipe"] = f(tmp, "gpipe.npz")
    return spec, ref


def unsharded(block):
    """``block`` without its seq axis: the unsharded reference."""
    import dataclasses

    return dataclasses.replace(block, seq_axis="", seq_axis_size=0)


def run_rank_world(torch, card, records, lm, tokens, tags,
                   backend="gloo"):
    """[alexnet-tp], [ring-attention] and [gpipe] (those of ``tags``) on
    one spawned world of two ranks (gloo: both on the card, the world's
    start paid once, as NCCL refuses two ranks a device; ``"nccl"``: a
    card a rank), each held against its
    reference made here (``world_inputs``); the new kernel shapes get
    ``[kernel]`` records first. Prints each phase's line and wall time;
    returns {tag: launch counts of both ranks' main path}."""
    import os
    import shutil
    import tempfile

    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import dispatch

    import gc

    tags = [t for t in WORLD_PHASES if t in tags]
    # the earlier phases' cached blocks back to the card: two ranks'
    # score tiles (3.2 GB each a block) share it with this process
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "alexnet-tp" in tags:
        shard_records(torch, F, records, "alexnet-tp", alexnet_tp_shapes(),
                      gen)
    if "gpipe" in tags:
        shard_records(torch, F, records, "gpipe", [(
            "stage", "matmul_block", dict(
                m=GPIPE_BATCH // GPIPE_MICRO, k=GPIPE_D, n=GPIPE_D,
                activation="relu"), ["stage0", "stage1"])], gen)
    tmp = tempfile.mkdtemp(prefix="dl4j_world_")
    try:
        t0 = time.perf_counter()
        spec, ref = world_inputs(torch, lm, tokens, tags, tmp)
        torch.cuda.empty_cache()
        inputs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn_ranks("world", _WORLD_RANK, [dict(
            spec, rank=r, phases=tags, rdv=os.path.join(tmp, "rdv"),
            backend=backend, out=os.path.join(tmp, f"rank{r}.json"))
            for r in range(2)], WORLD_TIMEOUT_S, tmp)
        world_s = time.perf_counter() - t0
        if any(rc != 0 for rc, _ in ranks):
            raise RuntimeError("[world] a rank failed:\n" + "\n---\n".join(
                f"exit {rc}: {err}" for rc, err in ranks))
        outs = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                outs.append(json.load(fh))
        print(f"[world] 2 {backend} ranks: inputs {inputs_s:.1f} s, "
              f"world {world_s:.1f} s")
        paths = {}
        for tag in tags:
            t0 = time.perf_counter()
            check = {"alexnet-tp": check_alexnet_tp,
                     "ring-attention": check_ring,
                     "gpipe": check_gpipe}[tag]
            mine = [o[tag] for o in outs]
            check(torch, card, mine, ref, spec, records)
            paths[tag] = {k: sum(o["launches"].get(k, 0) for o in mine)
                          for k in dispatch.KERNELS}
            print(f"[{tag}] phase {max(o['rank_s'] for o in mine) + time.perf_counter() - t0:.1f} s")
        return paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_alexnet_tp(torch, card, outs, ref, spec, records):
    """[alexnet-tp] against the world of one: each step's score (rtol
    TP_SCORE_RTOL), both ranks' scores equal, every weight within
    TP_SHARE of its 4-step move (``check_twin_step``), the shards half of each conv's out-channels and
    each dense layer's columns, and each rank's launches exactly TP_STEPS
    times one step's (10 conv_block, 4 conv_bwd_data, 5 conv_bwd_w, 3
    matmul_block: the head's product runs on the kernel under tensor
    parallelism)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import alexnet

    a, b = outs
    if a["scores"] != b["scores"]:
        raise RuntimeError(f"[alexnet-tp] the ranks' scores differ: "
                           f"{a['scores']} {b['scores']}")
    np.testing.assert_allclose(a["scores"], ref["scores"],
                               rtol=TP_SCORE_RTOL)
    want = expected_counts(conv_block=10 * TP_STEPS,
                           conv_bwd_data=4 * TP_STEPS,
                           conv_bwd_w=5 * TP_STEPS,
                           matmul_block=3 * TP_STEPS)
    for o in outs:
        if o["launches"] != want:
            raise RuntimeError(f"[alexnet-tp] a rank launched "
                               f"{o['launches']}, expected {want}")
    if (a["shapes"]["0/W"] != [48, 3, 11, 11]
            or a["shapes"]["8/W"] != [9216, 2048]
            or a["shapes"]["10/W"] != [4096, 500]
            or a["shapes"]["10/b"] != [1000]):
        raise RuntimeError(f"[alexnet-tp] shards: {a['shapes']}")
    got = MultiLayerNetwork(alexnet(), device="cpu")
    with np.load(spec["alexnet_tp_out"]) as z:
        got.params = {}
        for k in z.files:
            ln, pn = k.split("/")
            got.params.setdefault(ln, {})[pn] = torch.from_numpy(z[k])
    twin = MultiLayerNetwork(alexnet(), device="cpu")
    twin.params = ref["after"]
    share = check_twin_step("alexnet-tp", got, twin, ref["before"],
                            share=TP_SHARE)
    mine = [r for r in records if r["shape_of"].startswith("alexnet-tp.")]
    kinds = {}
    for r in mine:
        k = kinds.setdefault(r["kernel"], dict.fromkeys(
            ("kernel_ms", "library_ms", "plain_ms", "bound_ms"), 0.0))
        for key in k:
            k[key] += r[key] * r["launches_per_step"]
    res = {"steps": TP_STEPS, "batch": ALEXNET_TRAIN_BATCH,
           "mesh": {"data": 1, "model": TP_MODEL},
           "scores": a["scores"], "world_of_one_scores": ref["scores"],
           "max_share_of_move": share,
           "host_ms_per_step": a["host_ms"], "event_ms_per_step": a["event_ms"],
           "device_ms_one_step_rank0": a["device_ms_one_step"],
           "device_ms_one_step_rank1": b["device_ms_one_step"],
           "top_device_ms_rank0": a["top_device_ms"],
           "launches_per_step_per_rank": {
               k: v // TP_STEPS for k, v in a["launches"].items() if v},
           "kernel_ms_per_step_per_rank": kinds,
           "peak_gb_per_rank": [o["peak_gb"] for o in outs]}
    print(f"[alexnet-tp] {json.dumps(res)} card={card}")


def check_ring(torch, card, outs, ref, spec, records):
    """[ring-attention] against the unsharded blocks: each rank's forward
    rows and (rank 0) every gradient within RING_REL of the reference's
    largest entry, the loss of the two ranks' halves the reference's
    (rtol 1e-5), and each rank's launches 12 ``matmul_block_residual``
    a pass (two passes: the forward and the backward's) and no flash
    attention (the ring's products are einsums)."""
    for r, o in enumerate(outs):
        if o["fwd_err"] > RING_REL * o["fwd_scale"]:
            raise RuntimeError(f"[ring-attention] rank {r}'s forward is off "
                               f"by {o['fwd_err']} (scale {o['fwd_scale']})")
        want = expected_counts(matmul_block_residual=2 * TX["n_layers"])
        if o["launches"] != want:
            raise RuntimeError(f"[ring-attention] rank {r} launched "
                               f"{o['launches']}, expected {want}")
    worst = 0.0
    for k, (err, scale) in outs[0]["grad_errs"].items():
        if err > RING_REL * max(scale, 1e-30):
            raise RuntimeError(f"[ring-attention] gradient {k} is off by "
                               f"{err} (scale {scale})")
        worst = max(worst, err / max(scale, 1e-30))
    with np.load(spec["ring_grads"]) as z:
        n_grads = len(z.files)
    if len(outs[0]["grad_errs"]) != n_grads:
        raise RuntimeError(f"[ring-attention] held "
                           f"{len(outs[0]['grad_errs'])} of {n_grads} "
                           "gradients")
    np.testing.assert_allclose(outs[0]["loss"], ref["ring_loss"], rtol=1e-5)
    res = {"t_fwd": RING_T, "positions_a_rank_fwd": outs[0]["positions_fwd"],
           "bwd_batch": TX_BATCH, "bwd_t": TX_T,
           "fwd_ms": [o["fwd_ms"] for o in outs],
           "bwd_ms": [o["bwd_ms"] for o in outs],
           "fwd_max_rel_err": max(o["fwd_err"] / o["fwd_scale"]
                                  for o in outs),
           "grad_max_rel_err": worst, "loss": outs[0]["loss"],
           "reference_loss": ref["ring_loss"],
           "fwd_peak_gb": [o["fwd_peak_gb"] for o in outs],
           "launches_per_rank": {k: v for k, v in outs[0]["launches"].items()
                                 if v}}
    print(f"[ring-attention] {json.dumps(res)} card={card}")


def check_gpipe(torch, card, outs, ref, spec, records):
    """[gpipe] against the serial composition: the output on every rank
    and each stage's weights after two steps within GPIPE_REL of the
    reference's largest entry (the weights: of their move), the losses
    (rtol 1e-5), and each rank's launches: a forward tick a launch, 3
    passes (``apply`` and two steps) of n_micro + n_stages - 1 ticks."""
    ticks = GPIPE_MICRO + GPIPE_STAGES - 1
    for r, o in enumerate(outs):
        if o["out_err"] > GPIPE_REL * o["out_scale"]:
            raise RuntimeError(f"[gpipe] rank {r}'s output is off by "
                               f"{o['out_err']}")
        for k, (err, move) in o["param_errs"].items():
            if err > GPIPE_REL * move + 1e-7:
                raise RuntimeError(f"[gpipe] stage {r}'s {k} is off by {err}"
                                   f" (its move {move})")
        np.testing.assert_allclose(o["losses"], o["ref_losses"], rtol=1e-5)
        want = expected_counts(matmul_block=3 * ticks)
        if o["launches"] != want:
            raise RuntimeError(f"[gpipe] rank {r} launched {o['launches']},"
                               f" expected {want}")
    res = {"stages": GPIPE_STAGES, "n_micro": GPIPE_MICRO,
           "batch": GPIPE_BATCH, "d": GPIPE_D,
           "apply_ms": [o["apply_ms"] for o in outs],
           "train_step_ms": [o["step_ms"] for o in outs],
           "losses": outs[0]["losses"], "serial_losses": outs[0]["ref_losses"],
           "out_max_rel_err": max(o["out_err"] / o["out_scale"] for o in outs),
           "launches_per_rank": {k: v for k, v in outs[0]["launches"].items()
                                 if v}}
    print(f"[gpipe] {json.dumps(res)} card={card}")


def run_cluster(torch, card, device="cuda"):
    """[cluster] ``ClusterDl4jMultiLayer`` over the zoo's LeNet-5 (SGD) with
    a ``ParameterAveragingTrainingMaster`` of 4 workers x 64, averaging
    every step, on 16 minibatches of synthetic MNIST (4 rounds), held
    against one machine on each round's concatenated 256 rows (JAX
    ``tests/test_cluster.py:51``'s equivalence: each weight within
    CLUSTER_SHARE of its move); the sharded ``evaluate`` equal to the
    plain one; ``ClusterEarlyStoppingTrainer`` for at most 3 epochs on a
    holdout. Returns the launch counts of the main path: the cluster's
    ``fit`` and ``evaluate`` and the early-stopping trainer's ``fit``,
    each read just after it (the single-machine reference, the plain
    ``evaluate`` and the initial holdout score run outside them);
    ``device`` "cpu" rehearses it on the plain path, where no kernel
    launches."""
    from collections import Counter

    import warnings

    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.datasets import (
        DataSet,
        ListDataSetIterator,
        MnistDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.parallel import (
        ClusterDl4jMultiLayer,
        ParameterAveragingTrainingMaster,
    )
    from deeplearning4j_tpu_torch.zoo import lenet

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        data = MnistDataSetIterator(
            CLUSTER_BATCH, allow_synthetic=True,
            num_examples=CLUSTER_BATCH * (CLUSTER_MINIBATCHES
                                          + CLUSTER_HOLDOUT))
    batches = list(data)
    train, holdout = batches[:CLUSTER_MINIBATCHES], batches[
        CLUSTER_MINIBATCHES:]
    conf = lenet(updater="SGD")
    on_card = device != "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()
    net = per_step_loop(MultiLayerNetwork(conf, device=device).init())
    before = {ln: {pn: t.cpu() for pn, t in lp.items()}
              for ln, lp in net.params.items()}
    single = per_step_loop(MultiLayerNetwork(conf, device=device).init(
        params={ln: {pn: t.clone() for pn, t in lp.items()}
                for ln, lp in net.params.items()}))

    def master():
        return ParameterAveragingTrainingMaster(
            workers=CLUSTER_WORKERS, batch_size_per_worker=CLUSTER_BATCH,
            averaging_frequency=1, prefetch_num_batches=0,
            collect_training_stats=True)
    launches = Counter()

    def main_path(fn):
        """``fn()`` with its launches added to ``launches``."""
        sync()
        dispatch.reset_launch_counts()
        out = fn()
        sync()
        launches.update(dispatch.launch_counts())
        return out
    tm = master()
    cluster = ClusterDl4jMultiLayer(net, tm)
    t0 = time.perf_counter()
    main_path(lambda: cluster.fit(ListDataSetIterator(train)))
    fit_s = time.perf_counter() - t0
    for r in range(CLUSTER_MINIBATCHES // CLUSTER_WORKERS):
        part = train[r * CLUSTER_WORKERS:(r + 1) * CLUSTER_WORKERS]
        single.fit_minibatch(DataSet(
            np.concatenate([b.features for b in part]),
            np.concatenate([b.labels for b in part])))
    twin = MultiLayerNetwork(conf, device="cpu")
    twin.params = {ln: {pn: t.cpu() for pn, t in lp.items()}
                   for ln, lp in single.params.items()}
    share = check_twin_step("cluster", net, twin, before,
                            share=CLUSTER_SHARE)
    merged = main_path(lambda: cluster.evaluate(holdout))
    plain = net.evaluate(ListDataSetIterator(holdout))
    if (merged.accuracy(), merged.f1()) != (plain.accuracy(), plain.f1()):
        raise RuntimeError(f"[cluster] sharded evaluate {merged.accuracy()}"
                           f" / {merged.f1()}, plain {plain.accuracy()} / "
                           f"{plain.f1()}")
    es_net = per_step_loop(MultiLayerNetwork(conf, device=device).init())
    cfg = es.EarlyStoppingConfiguration(
        score_calculator=es.DataSetLossCalculator(
            ListDataSetIterator(holdout)),
        epoch_terminations=[es.MaxEpochsTerminationCondition(
            CLUSTER_ES_EPOCHS)],
        model_saver=es.InMemoryModelSaver())
    s0 = es.DataSetLossCalculator(ListDataSetIterator(
        holdout)).calculate_score(es_net)
    trainer = es.ClusterEarlyStoppingTrainer(cfg, es_net, master(),
                                             ListDataSetIterator(train))
    t0 = time.perf_counter()
    result = main_path(trainer.fit)
    es_s = time.perf_counter() - t0
    scores = [result.score_vs_epoch[e] for e in sorted(result.score_vs_epoch)]
    if (result.total_epochs != CLUSTER_ES_EPOCHS
            or not all(np.isfinite(scores))
            or not result.best_model_score < s0):
        raise RuntimeError(f"[cluster] early stopping: {result.total_epochs}"
                           f" epochs, scores {scores} from {s0}")
    for k in ("conv_block", "conv_bwd_w", "matmul_block"):
        if on_card and not launches.get(k):
            raise RuntimeError(f"[cluster] {k} never launched: {launches}")
    # LeNet's step launches conv_bwd_data once (conv2's dx): one a
    # cluster minibatch and one an early-stopping minibatch
    steps = CLUSTER_MINIBATCHES * (1 + CLUSTER_ES_EPOCHS)
    if on_card and launches.get("conv_bwd_data") != steps:
        raise RuntimeError(f"[cluster] {launches.get('conv_bwd_data')} "
                           f"conv_bwd_data launches, {steps} steps")
    res = {"workers": CLUSTER_WORKERS, "batch_per_worker": CLUSTER_BATCH,
           "minibatches": CLUSTER_MINIBATCHES, "fit_s": fit_s,
           "examples_per_s": CLUSTER_MINIBATCHES * CLUSTER_BATCH / fit_s,
           "max_share_of_move": share,
           "stats": tm.get_training_stats().as_dict(),
           "eval_accuracy": plain.accuracy(),
           "early_stopping": {"epochs": result.total_epochs,
                              "holdout_scores": scores, "initial": s0,
                              "best_epoch": result.best_model_epoch,
                              "seconds": es_s},
           "launches": {k: v for k, v in launches.items() if v}}
    print(f"[cluster] {json.dumps(res)} card={card}")
    return launches


# --- the rest of fit: the line-search solvers and layer-wise pretraining ----

DEEP_AE_WIDTHS = (784, 1000, 500, 250, 100, 30)  # DeepAutoEncoderExample
DEEP_AE_BATCH = 1000
DEEP_AE_BATCHES = 4        # the example's 60 an epoch, cut for time
VAE_BATCH = 128            # VariationalAutoEncoderExample
VAE_STEPS = 16
VAE_GRID = 10              # generate_at_mean_given_z over 10 x 10 z
LBFGS_BATCH = 256
LBFGS_MINIBATCHES = 4      # fit_minibatch calls an algorithm
SOLVER_TWIN_STEPS = 2
FLIP_SHARE = 1e-4          # chain samples the card and the CPU may flip
FIT_PATHS = ("deep-ae", "vae", "lenet-lbfgs")


@contextlib.contextmanager
def patched(owner, name, value):
    """``owner.name`` replaced by ``value`` within the block."""
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def host_params(model):
    return {ln: {pn: t.detach().cpu().clone() for pn, t in lp.items()}
            for ln, lp in model.params.items()}


def hold_params(tag, model, twin, rtol, atol):
    """Every parameter of ``model`` within (rtol, atol) of the CPU
    twin's; returns the largest absolute difference."""
    worst = 0.0
    for ln, lp in twin.params.items():
        for pn, ref in lp.items():
            got = model.params[ln][pn].detach().cpu()
            d = (got - ref).abs()
            worst = max(worst, float(d.max()))
            if bool((d > atol + rtol * ref.abs()).any()):
                raise RuntimeError(f"[{tag}] {ln}/{pn} differs from the twin "
                                   f"by {float(d.max())}")
    return worst


def sync_if(torch, on_card):
    if on_card:
        torch.cuda.synchronize()


def deep_ae_conf(widths=DEEP_AE_WIDTHS):
    """DeepAutoEncoderExample (deeplearning4j-examples,
    unsupervised/deepbelief): RBMs 784 -> 1000 -> 500 -> 250 -> 100 -> 30
    and back to 1000, a sigmoid OutputLayer 1000 -> 784 under MSE, line
    gradient descent, pretrain and backprop, one iteration a minibatch.
    Reduced: the example's KL_DIVERGENCE loss on each RBM is dropped (the
    RBM trains CD-k through its free energy and has no loss field)."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import RBM, OutputLayer

    sizes = list(widths) + list(widths[-2:0:-1])
    b = (NeuralNetConfiguration.Builder().seed(123).iterations(1)
         .optimization_algo("LINE_GRADIENT_DESCENT").list())
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        b = b.layer(RBM(n_in=n_in, n_out=n_out))
    return (b.layer(OutputLayer(n_in=sizes[-1], n_out=widths[0],
                                activation="sigmoid", loss="MSE"))
            .pretrain(True).backprop(True).build())


def run_deep_ae(torch, card, device="cuda", widths=DEEP_AE_WIDTHS,
                batch=DEEP_AE_BATCH, n_batches=DEEP_AE_BATCHES):
    """[deep-ae] the DeepAutoEncoder (``deep_ae_conf``, 2,882,028
    parameters) on binarized synthetic MNIST in batches of 1000, each
    batch its own label. First one pretrain iteration of each of the 9
    RBMs against the CPU twin: both run ``pretrain`` on the batch, each
    RBM on its own side's input; the twin's CD-1 chain replays the
    card's samples (the same draws of ``nn/random.py``; the samples the
    two sides' own chains flip at the margin of a Bernoulli draw are
    counted, at most FLIP_SHARE of them), so its update is held to
    kernel_tols. Then two line-search steps from the same weights: the
    scores and parameters to kernel_tols, the same accepted alpha. The
    main path is one ``fit`` of a fresh network over the batches: CD-1
    pretraining of the 9 RBMs, then a line-gradient-descent step a
    batch; the reconstruction score must fall. Every product here is
    plain torch (RBM and output layer, as in JAX, outside any Pallas
    kernel): the phase asserts zero kernel launches. The score on the
    first batch falls over the solver steps (from where pretraining left
    it; the times leave that read out). Reduced: the
    example's 60 batches an epoch cut to DEEP_AE_BATCHES; the RBMs'
    KL_DIVERGENCE loss dropped (``deep_ae_conf``). On the card a
    pretrain pass over one batch and one solver step are profiled after
    the main path (device ms, busy share against the main path's host
    ms). ``device`` "cpu" (and smaller ``widths`` / ``batch``) rehearses
    it."""
    import warnings

    from deeplearning4j_tpu_torch.datasets import (
        DataSet,
        MnistDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn.layers import RBM
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        data = MnistDataSetIterator(batch, allow_synthetic=True,
                                    binarize=True,
                                    num_examples=batch * n_batches)
    batches = [DataSet(features=ds.features, labels=ds.features)
               for ds in data]
    conf = deep_ae_conf(widths)
    on_card = device != "cpu"
    rtol, atol = TWIN_RTOL, TWIN_ATOL
    init = host_params(MultiLayerNetwork(conf, device="cpu").init())
    n_rbm = sum(isinstance(layer, RBM) for layer in conf.layers)

    # one pretrain iteration of each RBM, card and twin
    chain = RBM.gibbs_chain
    card_chains, flips = [], []

    def spy(self, params, v0, rng):
        v = chain(self, params, v0, rng)
        card_chains.append(v)
        return v

    def replay(self, params, v0, rng):
        own = chain(self, params, v0, rng)
        card_v = card_chains[len(flips)].cpu()
        flips.append((int((own != card_v).sum()), own.numel()))
        return card_v

    held = MultiLayerNetwork(conf, device=device).init(params=init)
    twin = MultiLayerNetwork(conf, device="cpu").init(params=init)
    with patched(RBM, "gibbs_chain", spy):
        held.pretrain([batches[0]])
    with patched(RBM, "gibbs_chain", replay):
        twin.pretrain([batches[0]])
    flipped = sum(f for f, _ in flips)
    if len(flips) != n_rbm or flipped > FLIP_SHARE * sum(n for _, n in flips):
        raise RuntimeError(f"[deep-ae] chains {len(flips)}, flipped samples "
                           f"{flips}")
    pretrain_diff = hold_params("deep-ae", held, twin, rtol, atol)
    # two line-search steps from the same weights
    twin.params = host_params(held)
    twin_scores, alphas = [], []
    for ds in batches[:SOLVER_TWIN_STEPS]:
        got = float(held.fit_minibatch(ds))
        ref = float(twin.fit_minibatch(ds))
        a = [float(s["alpha"]) for s in held._solver.last_steps]
        b = [float(s["alpha"]) for s in twin._solver.last_steps]
        if a != b or abs(got - ref) > atol + rtol * abs(ref):
            raise RuntimeError(f"[deep-ae] solver step: card {got} alpha {a},"
                               f" twin {ref} alpha {b}")
        twin_scores.append((got, ref))
        alphas.append(a[0])
    solver_diff = hold_params("deep-ae", held, twin, rtol, atol)
    del held, twin

    # the main path: fit pretrains the 9 RBMs, then a solver step a batch
    net = per_step_loop(MultiLayerNetwork(conf, device=device).init(
        params=init))
    initial = net.score(batches[0])
    clock = {}
    pretrain = net.pretrain

    def timed_pretrain(data, epochs=1):
        sync_if(torch, on_card)
        t0 = time.perf_counter()
        pretrain(data, epochs)
        sync_if(torch, on_card)
        t1 = time.perf_counter()
        clock["pretrain_s"] = t1 - t0
        # the score the fine-tuning starts from (taken out of the times)
        clock["pretrained_score"] = net.score(batches[0])
        clock["read_s"] = time.perf_counter() - t1

    class Trials:
        supports_batched_iterations = False

        def __init__(self):
            self.trials = []

        def iteration_done(self, model, iteration):
            self.trials += [s["trials"] for s in model._solver.last_steps]

    log = Trials()
    net.set_listeners(log)
    net.pretrain = timed_pretrain
    if on_card:  # the fit's own peak, above what was allocated before it
        torch.cuda.reset_peak_memory_stats()
        held_bytes = torch.cuda.memory_allocated()
    sync_if(torch, on_card)
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    net.fit(batches)
    sync_if(torch, on_card)
    fit_s = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - held_bytes if on_card
            else None)
    before, after = clock["pretrained_score"], net.score(batches[0])
    if any(launches.values()):
        raise RuntimeError(f"[deep-ae] a kernel launched: {launches}")
    if (not net._pretrain_done or net.iteration_count != n_batches
            or not after < before):
        raise RuntimeError(f"[deep-ae] fit: {net.iteration_count} steps, "
                           f"score {before} -> {after}")
    fit_s -= clock["read_s"]
    solve_s = fit_s - clock["pretrain_s"]
    pretrain_ms = clock["pretrain_s"] / (n_rbm * n_batches) * 1e3
    solver_ms = solve_s / n_batches * 1e3
    profile = {}
    if on_card:  # where a pretrain pass and a solver step spend the card
        for key, fn, n, host_ms in (
                ("pretrain_iteration", lambda: pretrain([batches[0]]), n_rbm,
                 pretrain_ms),
                ("solver_step", lambda: net.fit_minibatch(batches[1]), 1,
                 solver_ms)):
            dev, count, top = profiled_device(torch, fn)
            profile.update({f"device_ms_per_{key}": dev / n,
                            f"{key}_busy_share": dev / n / host_ms,
                            f"{key}_device_activities": count // n,
                            f"{key}_top_device_ms": top})
    res = {"params": net.num_params(), "rbms": n_rbm, "batch": batch,
           "batches": n_batches, "fit_s": fit_s,
           "ms_per_pretrain_iteration": pretrain_ms,
           "ms_per_solver_step": solver_ms, **profile,
           "line_search_trials": log.trials, "score_initial": initial,
           "score_pretrained": before, "score_after": after,
           "fit_peak_bytes": peak,
           "twin_pretrain_max_abs_diff": pretrain_diff,
           "twin_chain_flips": [f for f, _ in flips],
           "twin_solver_scores": twin_scores, "twin_alphas": alphas,
           "twin_solver_max_abs_diff": solver_diff,
           "launches": sum(launches.values())}
    print(f"[deep-ae] {json.dumps(res)} card={card}")
    return launches


def vae_conf(n_in=784, hidden=(256, 256)):
    """VariationalAutoEncoderExample (deeplearning4j-examples,
    unsupervised/variational): a VAE 784 -> 2 with encoder and decoder
    256, 256, leaky relu, an identity p(z|x), Bernoulli reconstruction
    through a sigmoid, RMSPROP at 1e-3, l2 1e-4, pretrain only."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (
        BernoulliReconstructionDistribution,
        VariationalAutoencoder,
    )

    return (NeuralNetConfiguration.Builder().seed(123).learning_rate(1e-3)
            .updater("RMSPROP").weight_init("XAVIER").l2(1e-4).list()
            .layer(VariationalAutoencoder(
                n_in=n_in, n_out=2, encoder_layer_sizes=hidden,
                decoder_layer_sizes=hidden, activation="leakyrelu",
                pzx_activation="identity",
                reconstruction_distribution=(
                    BernoulliReconstructionDistribution("sigmoid"))))
            .pretrain(True).backprop(False).build())


def run_vae(torch, card, device="cuda", hidden=(256, 256), batch=VAE_BATCH,
            steps=VAE_STEPS):
    """[vae] the MNIST VAE (``vae_conf``, 535,828 parameters) on
    synthetic MNIST in batches of 128. Step one against the CPU twin:
    the negative ELBO and its gradient at the step's key (its
    reparameterisation noise drawn by ``nn/random.py`` on each side) to
    kernel_tols of each gradient's largest entry; after the step
    (RMSPROP moves a weight by about lr / sqrt(0.05) whatever its
    gradient's size, so a gradient near zero can move either way) every
    weight within 3 such moves and at most 1 % of a parameter's entries
    beyond 1e-4 + 1e-3 |w|. The main path is ``fit`` over the batches,
    which pretrains (``backprop(False)``: no backprop after it); the
    negative ELBO at the posterior's mean on a probe batch must fall.
    Then ``reconstruction_probability`` of one batch and
    ``generate_at_mean_given_z`` over a 10 x 10 grid of z in [-2, 2]²,
    against the twin. Plain torch throughout (no Pallas kernel in JAX's
    VAE): zero kernel launches. Reduced: VAE_STEPS minibatches, not the
    example's epochs. On the card one more step runs under the profiler
    (device ms, busy share against the main path's host ms)."""
    import warnings

    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn import random
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        data = MnistDataSetIterator(batch, allow_synthetic=True,
                                    num_examples=batch * steps)
    batches = list(data)
    conf = vae_conf(hidden=hidden)
    layer = conf.layers[0]
    on_card = device != "cpu"
    init = host_params(MultiLayerNetwork(conf, device="cpu").init())
    name = conf.layer_name(0)
    # step one's key: fold_in(fold_in(PRNGKey(seed), 7919 + 0), 0)
    key = random.fold_in(random.fold_in(random.host_key(conf.seed), 7919), 0)

    def loss_and_grads(params, x):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = layer.pretrain_loss(leaves, x, key)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss.detach()), {k: g.cpu()
                                      for k, g in zip(leaves, grads)}

    held = MultiLayerNetwork(conf, device=device).init(params=init)
    twin = MultiLayerNetwork(conf, device="cpu").init(params=init)
    x0 = batches[0].features
    loss, grads = loss_and_grads(held.params[name],
                                 torch.from_numpy(x0).to(device))
    tloss, tgrads = loss_and_grads(twin.params[name], torch.from_numpy(x0))
    rtol, atol = TWIN_RTOL, TWIN_ATOL
    if abs(loss - tloss) > atol + rtol * abs(tloss):
        raise RuntimeError(f"[vae] step one's loss {loss}, twin {tloss}")
    grad_share = 0.0
    for k, ref in tgrads.items():
        scale = max(float(ref.abs().max()), 1e-30)
        share = float((grads[k] - ref).abs().max()) / scale
        grad_share = max(grad_share, share)
        if share > 10 * rtol:
            raise RuntimeError(f"[vae] d{k} differs by {share:.2e} of its "
                               "largest entry")
    held.pretrain([batches[0]])
    twin.pretrain([batches[0]])
    move = layer.learning_rate / (1.0 - layer.rms_decay) ** 0.5
    max_off = 0.0
    for pn, ref in twin.params[name].items():
        d = (held.params[name][pn].cpu() - ref).abs()
        off = float((d > 1e-4 + 1e-3 * ref.abs()).float().mean())
        max_off = max(max_off, off)
        if float(d.max()) > 3 * move or off > 0.01:
            raise RuntimeError(f"[vae] {pn} after step one: max "
                               f"{float(d.max())}, {off:.2%} off")

    # the main path: fit pretrains the VAE over the batches
    net = per_step_loop(MultiLayerNetwork(conf, device=device).init(
        params=init))
    probe = torch.from_numpy(batches[0].features).to(device)
    with torch.no_grad():
        before = float(layer.pretrain_loss(net.params[name], probe, None))
    sync_if(torch, on_card)
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    net.fit(batches)
    sync_if(torch, on_card)
    fit_s = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    with torch.no_grad():
        after = float(layer.pretrain_loss(net.params[name], probe, None))
    if any(launches.values()):
        raise RuntimeError(f"[vae] a kernel launched: {launches}")
    if not net._pretrain_done or net.iteration_count != 0 or not after < before:
        raise RuntimeError(f"[vae] fit: pretrained {net._pretrain_done}, "
                           f"{net.iteration_count} backprop steps, negative "
                           f"ELBO {before} -> {after}")
    profile = {}
    if on_card:  # one more step under the profiler, off the main path
        dev, count, top = profiled_device(
            torch, lambda: net.pretrain([batches[0]]))
        profile = {"device_ms_per_step": dev,
                   "busy_share": dev / (fit_s / steps * 1e3),
                   "device_activities": count, "top_device_ms": top}
    # scoring and generation against the twin on the trained weights
    twin = cpu_twin(torch, net)
    rp_key = random.fold_in(random.host_key(conf.seed), 1)
    g = np.linspace(-2.0, 2.0, VAE_GRID, dtype=np.float32)
    z = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    with torch.no_grad():
        rp = layer.reconstruction_probability(net.params[name], probe,
                                              rp_key).cpu()
        trp = layer.reconstruction_probability(
            twin.params[name], probe.cpu(), rp_key)
        gen = layer.generate_at_mean_given_z(
            net.params[name], torch.from_numpy(z).to(device)).cpu()
        tgen = layer.generate_at_mean_given_z(twin.params[name],
                                              torch.from_numpy(z))
    if (tuple(rp.shape) != (batch,) or not bool(torch.isfinite(rp).all())
            or tuple(gen.shape) != (VAE_GRID ** 2, 784)
            or not bool(((gen >= 0) & (gen <= 1)).all())):
        raise RuntimeError(f"[vae] reconstruction probability "
                           f"{tuple(rp.shape)}, generated {tuple(gen.shape)}")
    rp_diff = float(((rp - trp).abs() / trp.abs().clamp_min(1.0)).max())
    gen_diff = float((gen - tgen).abs().max())
    if rp_diff > 10 * rtol or gen_diff > atol + rtol:
        raise RuntimeError(f"[vae] against the twin: reconstruction "
                           f"probability {rp_diff:.2e}, generation "
                           f"{gen_diff:.2e}")
    res = {"params": net.num_params(), "batch": batch, "steps": steps,
           "fit_s": fit_s, "ms_per_step": fit_s / steps * 1e3,
           "samples_per_s": steps * batch / fit_s, **profile,
           "neg_elbo_before": before, "neg_elbo_after": after,
           "last_pretrain_score": net.score_value,
           "twin_step1_loss": (loss, tloss),
           "twin_step1_grad_share": grad_share,
           "twin_step1_share_off": max_off,
           "reconstruction_probability_mean": float(rp.mean()),
           "twin_reconstruction_probability_rel": rp_diff,
           "twin_generation_max_abs_diff": gen_diff,
           "launches": sum(launches.values())}
    print(f"[vae] {json.dumps(res)} card={card}")
    return launches


def fit_phases():
    """(tag, phase function) of the rest-of-fit slice's main paths, in
    FIT_PATHS's order."""
    fns = {"deep-ae": run_deep_ae, "vae": run_vae,
           "lenet-lbfgs": run_lenet_lbfgs}
    return [(tag, fns[tag]) for tag in FIT_PATHS]


def solver_step_launches(algo, trials, first_call):
    """One ``fit_minibatch``'s kernel launches under ``algo`` on LeNet-5
    (one iteration): a gradient launches conv_block 4 (each conv's
    forward and its f32 recompute), conv_bwd_data 1 (conv2's dx),
    conv_bwd_w 2 and matmul_block 1, a forward conv_block 2 and
    matmul_block 1; a step is one gradient (LBFGS two: the new point's)
    and ``1 + trials`` forwards, CG's first call one more gradient."""
    grad = {"conv_block": 4, "conv_bwd_data": 1, "conv_bwd_w": 2,
            "matmul_block": 1}
    fwd = {"conv_block": 2, "matmul_block": 1}
    grads = sum(2 if algo == "LBFGS" else 1 for _ in trials)
    if algo == "CONJUGATE_GRADIENT" and first_call:
        grads += 1
    forwards = sum(1 + t for t in trials)
    return {k: grads * grad.get(k, 0) + forwards * fwd.get(k, 0)
            for k in set(grad) | set(fwd)}


def run_lenet_lbfgs(torch, card, device="cuda", batch=LBFGS_BATCH,
                    minibatches=LBFGS_MINIBATCHES, dense_width=512):
    """[lenet-lbfgs] ``zoo.lenet()`` at full width with its
    optimization_algo set to LBFGS, then CONJUGATE_GRADIENT, on synthetic
    MNIST in batches of 256: the solvers on the kernels (the gradient
    through conv_block, conv_bwd_data, conv_bwd_w and matmul_block, each
    line-search trial a forward through conv_block and matmul_block).
    Two steps against the CPU twin from the same weights: the scores and
    parameters to kernel_tols, the same accepted alpha. The main path is
    LBFGS_MINIBATCHES ``fit_minibatch`` calls of a fresh network each,
    every call's launches exactly ``solver_step_launches`` of its
    line-search trials; the score must fall. On the card one more call
    runs under the profiler (device ms, busy share against the main
    path's median host ms)."""
    import warnings

    from collections import Counter

    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.zoo import lenet

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        data = MnistDataSetIterator(batch, allow_synthetic=True,
                                    num_examples=batch * minibatches)
    batches = list(data)
    on_card = device != "cpu"
    rtol, atol = TWIN_RTOL, TWIN_ATOL
    base = lenet(dense_width=dense_width).to_dict()
    launches = Counter()
    res = {"batch": batch, "minibatches": minibatches}
    for algo in ("LBFGS", "CONJUGATE_GRADIENT"):
        conf = MultiLayerConfiguration.from_dict(
            dict(base, optimization_algo=algo))
        init = host_params(MultiLayerNetwork(conf, device="cpu").init())
        held = MultiLayerNetwork(conf, device=device).init(params=init)
        twin = MultiLayerNetwork(conf, device="cpu").init(params=init)
        twin_scores, alphas = [], []
        for ds in batches[:SOLVER_TWIN_STEPS]:
            got = float(held.fit_minibatch(ds))
            ref = float(twin.fit_minibatch(ds))
            a = [float(s["alpha"]) for s in held._solver.last_steps]
            b = [float(s["alpha"]) for s in twin._solver.last_steps]
            if a != b or abs(got - ref) > atol + rtol * abs(ref):
                raise RuntimeError(f"[lenet-lbfgs] {algo}: card {got} alpha "
                                   f"{a}, twin {ref} alpha {b}")
            twin_scores.append((got, ref))
            alphas += a
        diff = hold_params("lenet-lbfgs", held, twin, rtol, atol)
        del held, twin
        # the main path: a fresh network, each call's launches exact
        net = per_step_loop(MultiLayerNetwork(conf, device=device).init(
            params=init))
        before = net.score(batches[0])
        ms, trials, scores = [], [], []
        for i, ds in enumerate(batches):
            sync_if(torch, on_card)
            dispatch.reset_launch_counts()
            t0 = time.perf_counter()
            score = net.fit_minibatch(ds)
            sync_if(torch, on_card)
            ms.append((time.perf_counter() - t0) * 1e3)
            got = dispatch.launch_counts()
            steps = [s["trials"] for s in net._solver.last_steps]
            want = solver_step_launches(algo, steps, i == 0)
            if on_card and any(got.get(k, 0) != want.get(k, 0)
                               for k in set(got) | set(want)):
                raise RuntimeError(f"[lenet-lbfgs] {algo} call {i}: "
                                   f"launched {got}, expected {want}")
            launches.update(got)
            trials += steps
            scores.append(float(score))
        after = net.score(batches[0])
        if not np.isfinite(after) or not after < before:
            raise RuntimeError(f"[lenet-lbfgs] {algo}: score {before} -> "
                               f"{after}")
        profile = {}
        if on_card:  # one more call under the profiler, off the main path
            dev, count, top = profiled_device(
                torch, lambda: net.fit_minibatch(batches[0]))
            profile = {"device_ms_per_solver_step": dev,
                       "busy_share": dev / float(np.median(ms)),
                       "device_activities": count, "top_device_ms": top}
        res[algo] = {"ms_per_solver_step": ms, "line_search_trials": trials,
                     "scores": scores, "score_before": before,
                     "score_after": after, "twin_scores": twin_scores,
                     "twin_alphas": alphas, "twin_max_abs_diff": diff,
                     "launches_first_call": solver_step_launches(
                         algo, trials[:1], True), **profile}
    res["launches"] = {k: v for k, v in launches.items() if v}
    print(f"[lenet-lbfgs] {json.dumps(res)} card={card}")
    return launches


# --- Keras's VGG-16 imported at 224 x 224, and the kernel tuner on it ------

KERAS_VGG_IMAGE = 224        # keras.applications.vgg16.VGG16's input
KERAS_VGG_WIDTHS = (64, 128, 256, 512, 512)
KERAS_VGG_CONVS = (2, 2, 3, 3, 3)
KERAS_VGG_FC = 4096
KERAS_VGG_CLASSES = 1000
KERAS_VGG_PARAMS = 138_357_544  # VGG16(include_top=True)
KERAS_VGG_BATCH = 16
KERAS_VGG_TWIN_BATCH = 2
KERAS_VGG_STEPS = 2
KERAS_VGG_SEED = 16
# Keras 1.x model configs carry no optimizer (compile() sets it): the
# phase trains the import with SGD at this rate, set after the import as
# a user would (the port's default of 0.1 diverges this un-normalized
# VGG-16 in one step: 15.5 -> 8.6e8, measured on one H100)
KERAS_VGG_LR = 1e-3
# the CPU twin's hold: the tests' kernel_tols on the CPU (f32 on both
# sides, TF32 off: sums in another order)
KERAS_VGG_RTOL, KERAS_VGG_ATOL = 2e-4, 2e-5
TUNE_BUDGET_MS = 500         # a search's measuring; 28 searches a step
TUNE_TIMEOUT_S = 300
TUNE_MARK = "[tune-child] "
TUNE_STALE_TORCH = "0.0.0-stale"


def keras_vgg16_config(image=KERAS_VGG_IMAGE, widths=KERAS_VGG_WIDTHS,
                       convs=KERAS_VGG_CONVS, fc=KERAS_VGG_FC,
                       classes=KERAS_VGG_CLASSES) -> str:
    """Keras 1.2's ``keras.applications.vgg16.VGG16(include_top=True)``
    layer stack (its layer names) as a Sequential ``to_json()`` config,
    ``dim_ordering="th"``: 3 x 3 ``Convolution2D`` with
    ``border_mode="same"`` and relu, 2 x 2 ``MaxPooling2D`` after each
    block, ``Flatten``, ``Dense`` fc1 / fc2 (relu) and predictions
    (softmax). Sequential, since the importer refuses the functional API
    (as the JAX importer does)."""
    layers = []
    for b, (width, n) in enumerate(zip(widths, convs), start=1):
        for i in range(1, n + 1):
            cfg = {"name": f"block{b}_conv{i}", "nb_filter": width,
                   "nb_row": 3, "nb_col": 3, "activation": "relu",
                   "border_mode": "same", "subsample": [1, 1],
                   "dim_ordering": "th", "init": "glorot_uniform",
                   "W_regularizer": None, "b_regularizer": None,
                   "bias": True}
            if not layers:
                cfg["batch_input_shape"] = [None, 3, image, image]
            layers.append({"class_name": "Convolution2D", "config": cfg})
        layers.append({"class_name": "MaxPooling2D", "config": {
            "name": f"block{b}_pool", "pool_size": [2, 2],
            "strides": [2, 2], "border_mode": "valid",
            "dim_ordering": "th"}})
    layers.append({"class_name": "Flatten", "config": {"name": "flatten"}})
    for name, width, act in (("fc1", fc, "relu"), ("fc2", fc, "relu"),
                             ("predictions", classes, "softmax")):
        layers.append({"class_name": "Dense", "config": {
            "name": name, "output_dim": width, "activation": act,
            "init": "glorot_uniform", "bias": True}})
    return json.dumps({"class_name": "Sequential", "config": layers,
                       "keras_version": "1.2.2"})


def keras_vgg16_weights(config_json: str, seed: int = KERAS_VGG_SEED) -> dict:
    """Seeded weights in Keras's own ``th`` layout for the layers of
    ``config_json`` (``keras_vgg16_config``'s): conv ``W`` [out, in,
    kh, kw] and Dense ``W`` [in, out], He-normal (relu keeps the
    activations O(1) through 16 layers), biases 0.01-normal; f32 from
    numpy's ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    cfg = json.loads(config_json)["config"]
    c, hw = 3, cfg[0]["config"]["batch_input_shape"][2]
    n_in = None
    out = {}
    for entry in cfg:
        kind, lc = entry["class_name"], entry["config"]
        if kind == "Convolution2D":
            shape = (lc["nb_filter"], c, lc["nb_row"], lc["nb_col"])
            fan, n_b = c * lc["nb_row"] * lc["nb_col"], lc["nb_filter"]
            c = lc["nb_filter"]
        elif kind == "MaxPooling2D":
            hw //= 2
            continue
        elif kind == "Flatten":
            n_in = c * hw * hw
            continue
        else:
            shape = (n_in, lc["output_dim"])
            fan, n_b = n_in, lc["output_dim"]
            n_in = lc["output_dim"]
        w = rng.standard_normal(shape, dtype=np.float32)
        w *= np.float32((2.0 / fan) ** 0.5)
        b = rng.standard_normal(n_b, dtype=np.float32) * np.float32(0.01)
        out[lc["name"]] = {"W": w, "b": b}
    return out


def keras_vgg16_batch(batch, image=KERAS_VGG_IMAGE,
                      classes=KERAS_VGG_CLASSES, seed=KERAS_VGG_SEED + 1):
    """One minibatch from a seed: standardized uint8 pixels ((p - 127.5)
    / 73.9) and one-hot labels."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    rng = np.random.default_rng(seed)
    pix = rng.integers(0, 256, (batch, 3, image, image), dtype=np.uint8)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, batch)]
    return DataSet((pix.astype(np.float32) - 127.5) / 73.9, y)


def keras_vgg16_shapes(batch=KERAS_VGG_BATCH, config=None):
    """The distinct kernel shapes of one training step of the imported
    VGG-16 at ``batch``: (first layer, kind, geometry, layers)."""
    from deeplearning4j_tpu_torch.modelimport import (
        import_sequential_model_config,
    )

    conf = import_sequential_model_config(config or keras_vgg16_config())
    return distinct_shapes(step_shapes(kernel_shapes(conf, batch)))


def with_learning_rate(net, lr):
    """``net`` (not yet trained) with every layer at learning rate
    ``lr``: the same parameters under a configuration that says so."""
    import dataclasses

    conf = dataclasses.replace(net.conf, layers=tuple(
        dataclasses.replace(layer, learning_rate=lr)
        for layer in net.conf.layers))
    return type(net)(conf, device=net.device).init(params=net.params)


class _no_hold:
    """``held_on_operands``'s stand-in where nothing is held (the CPU,
    and the tuning run)."""

    errors = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def run_keras_vgg16(torch, card, device="cuda", config=None,
                    batch=KERAS_VGG_BATCH, twin_batch=KERAS_VGG_TWIN_BATCH,
                    steps=KERAS_VGG_STEPS):
    """[keras-vgg16] Keras 1.2's VGG-16 (include_top, 224 x 224 x 3,
    1000 classes, ``th``) imported through ``modelimport.keras`` from its
    config JSON and seeded Keras-layout weights (no h5py): the import
    held exact; ``output`` at batch 16 with every conv and dense kernel
    call held against its plain version on its own operands; a batch-2
    CPU twin of the same import held at kernel_tols; 2 ``fit`` steps at
    batch 16, each step's launches exact. ``config``: another Keras
    config (the CPU rehearsal's narrow one). Returns the main path's
    launch counts."""
    from deeplearning4j_tpu_torch.modelimport import (
        import_sequential_model_arrays,
    )
    from deeplearning4j_tpu_torch.ops import dispatch

    on_card = device == "cuda"
    full = config is None
    config = keras_vgg16_config() if full else config
    first = json.loads(config)["config"][0]["config"]["batch_input_shape"]
    image = first[2]
    t0 = time.perf_counter()
    weights = keras_vgg16_weights(config)
    weights_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = per_step_loop(import_sequential_model_arrays(config, weights,
                                                       device=device))
    sync_if(torch, on_card)
    import_s = time.perf_counter() - t0
    net = per_step_loop(with_learning_rate(net, KERAS_VGG_LR))
    n_params = net.num_params()
    if full and n_params != KERAS_VGG_PARAMS:
        raise RuntimeError(f"[keras-vgg16] {n_params} params, expected "
                           f"{KERAS_VGG_PARAMS}")
    for ln, lp in weights.items():  # the th import is exact
        for pn, arr in lp.items():
            if not np.array_equal(net.params[ln][pn].cpu().numpy(), arr):
                raise RuntimeError(f"[keras-vgg16] {ln}/{pn} is not the "
                                   "Keras array")
    shapes = kernel_shapes(net.conf, batch)
    n_conv = sum(1 for s in shapes if s[1] == "conv_block")
    n_dense = sum(1 for s in shapes if s[1] == "matmul_block")
    classes = int(net.conf.layers[-1].n_out)
    print(f"[keras-vgg16] Keras 1.2 VGG16(include_top=True) as a Sequential "
          f"config ({len(json.loads(config)['config'])} Keras layers, "
          f"{n_conv} convs, {n_dense} fused dense, {n_params} params), "
          f"{image}x{image}x3 th, {classes} classes, batch {batch}, f32; "
          f"weights {weights_s:.2f} s, import {import_s:.2f} s")
    ds = keras_vgg16_batch(batch, image, classes)
    main = {}
    held = held_on_operands(dense=True) if on_card else _no_hold()
    dispatch.reset_launch_counts()
    with held:
        out = net.output(ds.features)
    sync_if(torch, on_card)
    per_output = dispatch.launch_counts()
    if on_card:
        if per_output != expected_counts(conv_block=n_conv,
                                         matmul_block=n_dense):
            raise RuntimeError(f"[keras-vgg16] output launched {per_output}")
        if {k: n for k, (n, _) in held.errors.items()} != {
                "conv_block": n_conv, "matmul_block": n_dense}:
            raise RuntimeError(f"[keras-vgg16] held calls: {held.errors}")
    add_counts(main, per_output)
    out = out.float().cpu()
    if tuple(out.shape) != (batch, classes) or not bool(
            torch.isfinite(out).all()) or not torch.allclose(
                out.sum(1), torch.ones(batch), atol=1e-4):
        raise RuntimeError(f"[keras-vgg16] bad output {tuple(out.shape)}")
    # the CPU twin: the same import on the CPU, on the first rows
    twin_err = None
    if on_card:
        twin = import_sequential_model_arrays(config, weights, device="cpu")
        small = ds.features[:twin_batch]
        want = twin.output(small)
        got = net.output(small).cpu()
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=KERAS_VGG_RTOL, atol=KERAS_VGG_ATOL)
        twin_err = float((got - want).abs().max())
        del twin
    reps = 3
    net.output(ds.features)
    sync_if(torch, on_card)
    t0 = time.perf_counter()
    for _ in range(reps):
        net.output(ds.features)
    sync_if(torch, on_card)
    fwd_ms = (time.perf_counter() - t0) / reps * 1e3
    # the main path's steps, each one's launches exact
    want_step = expected_counts(conv_block=2 * n_conv,
                                conv_bwd_data=n_conv - 1, conv_bwd_w=n_conv,
                                matmul_block=n_dense)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    scores, step_ms = [], []
    for _ in range(steps):
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        scores.append(float(net.fit_minibatch(ds)))
        sync_if(torch, on_card)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = dispatch.launch_counts()
        if on_card and launches != want_step:
            raise RuntimeError(f"[keras-vgg16] a step launched {launches}")
        add_counts(main, launches)
    if not all(np.isfinite(scores)) or not scores[-1] < scores[0]:
        raise RuntimeError(f"[keras-vgg16] the score did not fall: {scores}")
    res = {"batch": batch, "params": n_params, "forward_ms": fwd_ms,
           "learning_rate": KERAS_VGG_LR,
           "forward_images_per_s": batch / fwd_ms * 1e3,
           "step_ms": step_ms, "images_per_s": batch / step_ms[-1] * 1e3,
           "scores": scores, "twin_batch": twin_batch,
           "twin_output_max_abs_err": twin_err,
           "twin_tolerance": f"rtol {KERAS_VGG_RTOL}, atol {KERAS_VGG_ATOL}",
           "launches_per_output": {k: v for k, v in per_output.items() if v},
           "launches_per_step": {k: v for k, v in want_step.items() if v},
           "kernels_on_operands_max_rel_err": {
               k: e for k, (_, e) in held.errors.items()},
           "weights_s": weights_s, "import_s": import_s}
    if on_card:
        res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        device_ms, top = profiled_device_ms(
            torch, lambda: net.fit_minibatch(ds))
        res.update(device_ms_per_step=device_ms,
                   device_busy_share=device_ms / step_ms[-1],
                   top_device_ms_per_step={k[:60]: v for k, v in top.items()})
    print(f"[keras-vgg16] {json.dumps(res)} card={card}")
    return main


def metric_total(name, **labels):
    """The default registry's ``name`` summed over its series (those
    with ``labels``): a counter's value, a histogram's count."""
    from deeplearning4j_tpu_torch.observability.metrics import (
        default_registry,
    )

    fam = default_registry().get(name)
    if fam is None:
        return 0
    kids = [k for k in fam.children()
            if dict(zip(fam.label_names, k.label_values)).items()
            >= labels.items()]
    return sum(k.count if hasattr(k, "count") else k.value for k in kids)


def tune_report(mode, held) -> dict:
    """Every plan this process resolved, each with its persisted entry's
    times (the heuristic's, the winner's, every plan measured), and the
    tuner's counters."""
    from deeplearning4j_tpu_torch.ops import autotune, tiling

    shapes = []
    for (kernel, items), plan in sorted(autotune.resolved().items()):
        ident = dict(items)
        entry = autotune.read_entry(kernel, ident) or {}
        times = entry.get("timings_ms", {})
        heur = entry.get("heuristic")
        shapes.append({
            "kernel": kernel, "identity": ident,
            "plan": tiling.plan_tag(plan),
            "persisted": entry.get("config") == list(plan),
            "heuristic": None if heur is None else tiling.plan_tag(heur),
            "heuristic_ms": None if heur is None
            else times.get(tiling.plan_tag(heur)),
            "winner_ms": times.get(tiling.plan_tag(plan)),
            "measured": times})
    return {"mode": mode, "shapes": shapes,
            "searches": metric_total("tuner_searches_total"),
            "measurements": metric_total("tuner_measure_ms"),
            "hits": metric_total("tuner_cache_hits_total"),
            "fallbacks": metric_total("tuner_fallback_total"),
            "held_max_rel_err": {k: e for k, (_, e) in held.errors.items()},
            "held_calls": {k: n for k, (n, _) in held.errors.items()}}


def make_stale(torch, net, x) -> dict:
    """Rewrite the first persisted forward entry as if another torch had
    measured it, re-read the tuner's environment, run the forward again:
    that shape's entry must be refused as stale, counted, and its plan
    the heuristic's."""
    from deeplearning4j_tpu_torch.ops import autotune, dispatch, tiling

    key, plan = next((k, p) for k, p in sorted(autotune.resolved().items())
                     if k[0] == "conv_block")
    ident = dict(key[1])
    path = autotune.entry_path("conv_block", ident)
    with open(path) as f:
        doc = json.load(f)
    doc["fingerprint"]["torch"] = TUNE_STALE_TORCH
    with open(path, "w") as f:
        json.dump(doc, f)
    dispatch.reset_for_tests()
    stale0 = metric_total("tuner_fallback_total", kernel="conv_block",
                          reason="stale")
    net.output(x)
    torch.cuda.synchronize()
    heur = tiling.conv_fwd_heuristic(
        ident["n"], ident["c"], ident["h"], ident["w"], ident["o"],
        ident["kh"], ident["kw"], (ident["sh"], ident["sw"]),
        (ident["ph"], ident["pw"]), torch.float32)
    return {"identity": ident, "was": tiling.plan_tag(plan),
            "resolved": tiling.plan_tag(autotune.resolved()[key]),
            "heuristic": tiling.plan_tag(heur),
            "counted": metric_total("tuner_fallback_total",
                                    kernel="conv_block", reason="stale")
            - stale0}


def tune_child() -> dict:
    """One [autotune] subprocess (``DL4J_TPU_TUNE`` and the cache
    directory in its environment): the imported VGG-16's forward and one
    training step at batch 16 (random weights: the tuner times shapes),
    then ``tune_report``. In ``cached`` mode each kernel call is held
    against its plain version on its operands, and then ``make_stale``."""
    import torch

    from deeplearning4j_tpu_torch.modelimport import (
        import_sequential_model_config,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _build, autotune

    _build.load()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mode = autotune.tuning_mode()
    conf = import_sequential_model_config(keras_vgg16_config())
    net = per_step_loop(MultiLayerNetwork(conf, device="cuda").init())
    ds = keras_vgg16_batch(KERAS_VGG_BATCH)
    held = held_on_operands(dense=True) if mode == "cached" else _no_hold()
    t0 = time.perf_counter()
    with held:
        out = net.output(ds.features)
        score = float(net.fit_minibatch(ds))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if not bool(torch.isfinite(out).all()) or not np.isfinite(score):
        raise RuntimeError(f"tune child ({mode}): output or score not finite")
    rep = dict(tune_report(mode, held), wall_s=wall_s, score=score)
    if mode == "cached":
        rep["stale"] = make_stale(torch, net, ds.features)
    return rep


def _tune_subprocess(mode, cache, timeout_s=TUNE_TIMEOUT_S) -> dict:
    env = dict(os.environ, DL4J_TPU_TUNE=mode, DL4J_TPU_TUNE_CACHE_DIR=cache,
               DL4J_TPU_TUNE_BUDGET_MS=str(TUNE_BUDGET_MS))
    code = ("import json, chip_smoke as cs; "
            "print(cs.TUNE_MARK + json.dumps(cs.tune_child()))")
    proc = subprocess.run(
        [sys.executable, "-X", "faulthandler", "-c", code], env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=timeout_s)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(TUNE_MARK)]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"[autotune] the {mode} child failed "
                           f"(rc {proc.returncode}):\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-6000:]}")
    return json.loads(lines[-1][len(TUNE_MARK):])


def check_tuning(on, cached, n_shapes) -> dict:
    """The [autotune] holds: the tuning run persisted a winner for every
    shape, none slower than its heuristic as measured; the cached run
    measured nothing and used those winners; the stale entry was
    refused, counted and resolved to the heuristic."""
    if len(on["shapes"]) != n_shapes or on["searches"] != n_shapes:
        raise RuntimeError(f"[autotune] tuned {len(on['shapes'])} shapes in "
                           f"{on['searches']} searches, expected {n_shapes}")
    for s in on["shapes"]:
        if not s["persisted"] or s["heuristic_ms"] is None:
            raise RuntimeError(f"[autotune] not persisted: {s}")
        if s["winner_ms"] > s["heuristic_ms"]:
            raise RuntimeError(f"[autotune] winner slower than the "
                               f"heuristic as measured: {s}")

    def plans(rep):
        return {(s["kernel"], json.dumps(s["identity"], sort_keys=True)):
                s["plan"] for s in rep["shapes"]}
    if plans(cached) != plans(on):
        raise RuntimeError("[autotune] the cached run's plans differ from "
                           "the persisted winners")
    if cached["searches"] or cached["measurements"] or \
            cached["hits"] != n_shapes or cached["fallbacks"]:
        raise RuntimeError(f"[autotune] the cached run searched "
                           f"{cached['searches']}, measured "
                           f"{cached['measurements']}, hit {cached['hits']}, "
                           f"fell back {cached['fallbacks']}")
    stale = cached["stale"]
    if stale["counted"] != 1 or stale["resolved"] != stale["heuristic"]:
        raise RuntimeError(f"[autotune] stale entry not refused: {stale}")
    return {"shapes": n_shapes, "changed": sum(
        s["plan"] != s["heuristic"] for s in on["shapes"])}


def run_autotune(torch, card):
    """[autotune] the kernel tuner on [keras-vgg16]'s shapes, in two
    subprocesses on one temporary cache directory: ``DL4J_TPU_TUNE=on``
    measures every kernel shape of the forward and one training step at
    batch 16 (the heuristic and the top 4 by prior, best of 3 rounds of
    4 calls, TUNE_BUDGET_MS a search) and persists the winners;
    ``cached`` runs the same step measuring nothing, on those winners,
    each kernel call held against its plain version; then a stale entry
    is refused. The launches run in the children: this process's main
    path launches nothing."""
    import shutil
    import tempfile

    n_shapes = len(keras_vgg16_shapes())
    cache = tempfile.mkdtemp(prefix="dl4j-tune-")
    try:
        on = _tune_subprocess("on", cache)
        cached = _tune_subprocess("cached", cache)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    summary = check_tuning(on, cached, n_shapes)
    for s in on["shapes"]:
        print(f"[autotune] {s['kernel']} {json.dumps(s['identity'])}: "
              f"heuristic {s['heuristic']} {s['heuristic_ms']:.4f} ms -> "
              f"winner {s['plan']} {s['winner_ms']:.4f} ms "
              f"({len(s['measured'])} measured: "
              f"{json.dumps(s['measured'])})")
    res = dict(summary, tune_wall_s=on["wall_s"],
               cached_wall_s=cached["wall_s"],
               heuristic_ms_sum=sum(s["heuristic_ms"] for s in on["shapes"]),
               winner_ms_sum=sum(s["winner_ms"] for s in on["shapes"]),
               cached_searches=cached["searches"],
               cached_measurements=cached["measurements"],
               cached_hits=cached["hits"], stale=cached["stale"],
               cached_held_max_rel_err=cached["held_max_rel_err"],
               cached_held_calls=cached["held_calls"])
    print(f"[autotune] {json.dumps(res)} card={card}")
    return {}


TUNE_PATHS = ("keras-vgg16", "autotune")


def tune_phases():
    """(tag, function, extra arguments) of the tuning slice's phases, in
    order: [autotune] reads the shapes [keras-vgg16] launched."""
    return (("keras-vgg16", run_keras_vgg16, ()),
            ("autotune", run_autotune, ()))


# --- the host periphery: the training UI, t-SNE, streaming, object-store
# datasets and the native loader (PERIPHERY_PATHS) ---------------------------

UI_STEPS = 10
UI_FREQUENCY = 5
UI_CHUNK_BATCHES = 32  # two chunks of 16 at the default scan_chunk
UI_CHUNK_FREQUENCY = 16
TSNE_N = 5000
TSNE_DIM = 128
TSNE_CLUSTERS = 10
TSNE_ITERS = 1000
TSNE_TWIN_ITERS = 10
TSNE_TWIN_REL = 1e-5
TSNE_MIN_AGREEMENT = 0.9
STREAM_BATCHES = 20
NATIVE_MNIST_ROWS = 60000
NATIVE_CIFAR_ROWS = 10000
UI_ENDPOINTS = ("/", "/train", "/train/sessions", "/train/overview?sid={sid}",
                "/train/histograms?sid={sid}", "/train/model?sid={sid}",
                "/train/system?sid={sid}", "/train/tsne",
                "/train/graph?sid={sid}", "/train/activations", "/debugz",
                "/metrics", "/metrics?format=prometheus")
PERIPHERY_PATHS = ("ui", "ui-chunk", "tsne", "stream", "cloud-data",
                   "native")


def http_get(port: int, path: str) -> bytes:
    """GET ``path`` of a local server; raises unless it answers 200."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"GET {path} answered {resp.status}: {body[:200]}")
    return body


def read_png_gray(data: bytes) -> np.ndarray:
    """An 8-bit grayscale PNG (one or more IDAT chunks, filter 0 rows, as
    the conv listener writes them) as a [H, W] uint8 array, each chunk's
    CRC checked."""
    import struct
    import zlib

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise RuntimeError("not a PNG")
    at, idat, size = 8, b"", None
    while at < len(data):
        (n,) = struct.unpack(">I", data[at:at + 4])
        kind, body = data[at + 4:at + 8], data[at + 8:at + 8 + n]
        (crc,) = struct.unpack(">I", data[at + 8 + n:at + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise RuntimeError(f"bad CRC in the PNG's {kind!r} chunk")
        if kind == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", body[:10])
            if (depth, colour) != (8, 0):
                raise RuntimeError(f"not 8-bit grayscale: {depth}, {colour}")
            size = (h, w)
        elif kind == b"IDAT":
            idat += body
        at += 12 + n
    h, w = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    if rows[:, 0].any():
        raise RuntimeError("a scanline filter other than 0")
    return rows[:, 1:].copy()


def grid_diffs(tag, grids, acts, names):
    """The conv listener's base64 PNG ``grids`` decoded with
    ``read_png_gray`` against the tiles of ``acts`` (a forward's
    activations, one per layer of ``names``): {layer: the largest
    gray-level difference} over every 4-d layer."""
    import base64

    from deeplearning4j_tpu_torch.ui.conv_listener import _tile_grid

    want = {str(n): a for n, a in zip(names, acts) if a.dim() == 4}
    if sorted(grids) != sorted(want):
        raise RuntimeError(f"[{tag}] grids of {sorted(grids)}, the forward "
                           f"has 4-d layers {sorted(want)}")
    diffs = {}
    for name, act in want.items():
        got = read_png_gray(base64.b64decode(grids[name]))
        ref = _tile_grid(act[0].detach().float().cpu().numpy())
        if got.shape != ref.shape:
            raise RuntimeError(f"[{tag}] layer {name}: grid {got.shape}, "
                               f"tiles {ref.shape}")
        diffs[name] = int(np.abs(got.astype(int) - ref.astype(int)).max())
    return diffs


def grids_against(tag, grids, acts, names):
    """``grid_diffs``, each grid within 1 gray level of its tiles."""
    diffs = grid_diffs(tag, grids, acts, names)
    off = {k: v for k, v in diffs.items() if v > 1}
    if off:
        raise RuntimeError(f"[{tag}] grids off their tiles by {off} gray "
                           "levels")
    return diffs


def f32_mean_rtol(n: int) -> float:
    """The bound on the relative rounding of numpy's float32 mean of ``n``
    non-negative values (the StatsListener's ``np.mean(np.abs(a))``): a
    unit roundoff (2**-24) for each addition on the longest path of its
    pairwise sum (15 within one of 8 accumulators of a 128-value block,
    3 joining them, one a level above the blocks) and one for the
    division. At fc6's 37,748,736 weights that is 2.3e-6 (1.87e-6 seen
    on normal draws): tighter than the f64 means of the card it is held
    to cannot be asked."""
    levels = int(np.ceil(np.log2(max(n / 128, 1))))
    return 2.0 ** -24 * (15 + 3 + levels + 1)


class ScoreTap:
    """A listener keeping each step's score (a device scalar, read after
    the fit) and, every ``frequency`` iterations, the parameters' mean
    magnitudes and their updates since the last sample, computed on the
    card in f64 (device scalars), and each parameter's size."""

    supports_batched_iterations = True

    def __init__(self, frequency: int):
        self.frequency = frequency
        self.scores = {}
        self.mags = {}
        self.updates = {}
        self.sizes = {}
        self._prev = None

    def iteration_done(self, model, iteration: int) -> None:
        self.scores[iteration] = model._last_score
        if iteration % self.frequency:
            return
        cur = {f"{ln}_{pn}": t.detach() for ln, lp in model.params.items()
               for pn, t in lp.items()}
        self.sizes = {k: t.numel() for k, t in cur.items()}
        self.mags[iteration] = {k: t.double().abs().mean()
                                for k, t in cur.items()}
        if self._prev is not None:
            self.updates[iteration] = {
                k: (t - self._prev[k]).double().abs().mean()
                for k, t in cur.items()}
        self._prev = {k: t.clone() for k, t in cur.items()}


class SyncClock:
    """A listener noting, after waiting for the card, the host time at
    each ``iteration_done``: each interval is a step and its listeners."""

    supports_batched_iterations = True

    def __init__(self, torch):
        self.torch = torch
        self.times = []

    def iteration_done(self, model, iteration: int) -> None:
        self.torch.cuda.synchronize()
        self.times.append(time.perf_counter())


class FanOut:
    """A stats router over several (the reference's
    ``StatsStorageRouter`` fan-out): each record to every router."""

    def __init__(self, *routers):
        self.routers = routers

    def put_static_info(self, rec) -> None:
        for r in self.routers:
            r.put_static_info(rec)

    def put_update(self, rec) -> None:
        for r in self.routers:
            r.put_update(rec)


def alexnet_card_batches(torch):
    """[alexnet-train]'s two minibatches of 128 standardized pixels, on
    the card."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    return [DataSet(torch.from_numpy(
        (b.features.astype(np.float32) - 127.5) / 73.9).cuda(),
        torch.from_numpy(b.labels.astype(np.float32)).cuda())
        for b in resnet_batches(2, ALEXNET_TRAIN_BATCH, seed=13)]


def run_ui(torch, card):
    """[ui] the zoo's AlexNet (224 x 224 x 3, 1000 classes, f32, batch
    128, [alexnet-train]'s minibatches) fits 10 steps through ``fit``
    under ``StatsListener(frequency=5, collect_histograms=True)``
    (routed to an ``InMemoryStatsStorage``, a ``FileStatsStorage`` and a
    ``RemoteUIStatsStorageRouter`` posting to a second ``UIServer``) and
    ``ConvolutionalIterationListener(frequency=5)`` (each of its batch-1
    kernel calls held to its plain version on its operands), both
    feeding a ``UIServer`` on port 0: the sampled scores equal the net's,
    the magnitudes equal the card's own f64 means within numpy's float32
    rounding of a mean (``f32_mean_rtol``: 1.1e-6 to 2.3e-6), the
    remote server and the file hold every update, every endpoint answers
    200, ``/train/system`` and ``/debugz`` name the card, and each grid
    decodes to the tiles of the plain version's batch-1 forward within 1
    gray level. Then a second run of 10 steps times a step with and
    without a sampled report. Returns the launches of the first run."""
    import tempfile

    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.ui import (
        ConvolutionalIterationListener,
        FileStatsStorage,
        InMemoryStatsStorage,
        RemoteUIStatsStorageRouter,
        StatsListener,
        UIServer,
    )
    from deeplearning4j_tpu_torch.zoo import alexnet

    kind = torch.cuda.get_device_name(0)
    conf = alexnet()
    batches = alexnet_card_batches(torch)
    net = MultiLayerNetwork(conf, device="cuda").init()
    init = {ln: {pn: t.clone() for pn, t in lp.items()}
            for ln, lp in net.params.items()}
    print(f"[ui] zoo.alexnet() ({net.num_params()} params), batch "
          f"{ALEXNET_TRAIN_BATCH}, {UI_STEPS} steps, StatsListener and "
          f"ConvolutionalIterationListener every {UI_FREQUENCY}")
    tmp = tempfile.mkdtemp(prefix="dl4j_ui_")
    server, remote = UIServer(port=0), UIServer(port=0)
    held = held_on_operands(dense=True)

    class HeldConvListener(ConvolutionalIterationListener):
        def iteration_done(self, model, iteration):
            with held:
                super().iteration_done(model, iteration)

    try:
        remote.enable_remote_listener()
        mem = InMemoryStatsStorage()
        file_path = os.path.join(tmp, "stats.jsonl")
        router = RemoteUIStatsStorageRouter(
            f"http://127.0.0.1:{remote.port}", raise_on_error=True)
        server.attach(mem)
        stats = StatsListener(FanOut(mem, FileStatsStorage(file_path),
                                     router),
                              frequency=UI_FREQUENCY,
                              collect_histograms=True, session_id="alexnet")
        conv = HeldConvListener(server, frequency=UI_FREQUENCY)
        tap = ScoreTap(UI_FREQUENCY)
        net.set_listeners(stats, conv, tap)
        dispatch.reset_launch_counts()
        net.fit(batches, epochs=UI_STEPS // len(batches))
        torch.cuda.synchronize()
        launches = dispatch.launch_counts()
        step = expected_counts(conv_block=10, conv_bwd_data=4, conv_bwd_w=5,
                               matmul_block=2)
        samples = UI_STEPS // UI_FREQUENCY
        want = {k: v * UI_STEPS for k, v in step.items()}
        want["conv_block"] += 5 * samples   # the listener's batch-1 forward
        want["matmul_block"] += 2 * samples
        if net.iteration_count != UI_STEPS or launches != want:
            raise RuntimeError(f"[ui] {net.iteration_count} steps launched "
                               f"{launches}, expected {want}")
        if {k: n for k, (n, _) in held.errors.items()} != {
                "conv_block": 5 * samples, "matmul_block": 2 * samples}:
            raise RuntimeError(f"[ui] held calls: {held.errors}")
        # the records: scores, magnitudes, the remote copy, the file
        ups = mem.get_all_updates("alexnet", "worker-0")
        its = [u.iteration for u in ups]
        if its != list(range(UI_FREQUENCY, UI_STEPS + 1, UI_FREQUENCY)):
            raise RuntimeError(f"[ui] sampled iterations {its}")
        worst_mag = 0.0
        for u in ups:
            if u.score != float(tap.scores[u.iteration]):
                raise RuntimeError(f"[ui] iteration {u.iteration}: sampled "
                                   f"score {u.score}, the net's "
                                   f"{float(tap.scores[u.iteration])}")
            for got, ref in ((u.param_mean_magnitudes,
                              tap.mags[u.iteration]),
                             (u.update_mean_magnitudes,
                              tap.updates.get(u.iteration, {}))):
                if sorted(got) != sorted(ref):
                    raise RuntimeError(f"[ui] keys {sorted(got)} against "
                                       f"{sorted(ref)}")
                for k, v in got.items():
                    r = float(ref[k])
                    rel = abs(v - r) / max(abs(r), 1e-30)
                    worst_mag = max(worst_mag, rel / f32_mean_rtol(
                        tap.sizes[k]))
                    if rel > f32_mean_rtol(tap.sizes[k]):
                        raise RuntimeError(f"[ui] {k} at {u.iteration}: {v} "
                                           f"against the card's {r}")
            if sorted(u.param_histograms) != sorted(u.param_mean_magnitudes):
                raise RuntimeError("[ui] a histogram is missing")
        if not ups[-1].update_mean_magnitudes:
            raise RuntimeError("[ui] no update magnitudes at the 2nd sample")
        held_remote = remote.primary_storage().get_all_updates(
            "alexnet", "worker-0")
        on_file = FileStatsStorage(file_path).get_all_updates(
            "alexnet", "worker-0")
        for where, recs in (("remote", held_remote), ("file", on_file)):
            if [r.encode() for r in recs] != [u.encode() for u in ups]:
                raise RuntimeError(f"[ui] the {where} copy holds "
                                   f"{len(recs)} updates, not the {len(ups)}"
                                   " local ones")
        # every endpoint, then the t-SNE post (run on the CPU)
        sizes = {}
        for where, srv in (("local", server), ("remote", remote)):
            for path in UI_ENDPOINTS:
                p = path.format(sid="alexnet")
                sizes[where + p] = len(http_get(srv.port, p))
        tsne_in = np.random.RandomState(3).randn(64, 16).tolist()
        code, posted, _, _ = post_json(
            server.port, {"vectors": tsne_in,
                          "labels": [str(i % 4) for i in range(64)]},
            path="/tsne/post")
        coords = json.loads(http_get(server.port, "/train/tsne"))["coords"]
        if code != 200 or posted["points"] != 64 or np.shape(coords) != (
                64, 2) or not np.all(np.isfinite(coords)):
            raise RuntimeError(f"[ui] /tsne/post gave {posted}, "
                               f"{np.shape(coords)}")
        system = http_get(server.port, "/train/system?sid=alexnet").decode()
        debugz = http_get(server.port, "/debugz").decode()
        for name, body in (("/train/system", system), ("/debugz", debugz)):
            if kind not in body:
                raise RuntimeError(f"[ui] {name} does not name {kind}")
        # the grids: the last sample's snapshot through the plain version
        grids = json.loads(http_get(server.port, "/train/activations")
                           )["grids"]
        x1 = net._last_features[:1]
        if x1.data_ptr() != batches[-1].features.data_ptr():
            raise RuntimeError("[ui] the snapshot is not the last batch")
        twin = cpu_twin(torch, net)
        diffs = grids_against("ui", grids, twin.feed_forward(
            x1.cpu()), net.layer_names)
        if len(diffs) != 8:
            raise RuntimeError(f"[ui] {len(diffs)} grids, not 8")
        del twin

        # timing: 10 more steps from the same start, no held calls, each
        # step waited for: a step with and without a sampled report
        timed = MultiLayerNetwork(conf, device="cuda").init(params=init)
        clock = SyncClock(torch)
        timed_mem = InMemoryStatsStorage()
        timed.set_listeners(
            StatsListener(timed_mem, frequency=UI_FREQUENCY,
                          collect_histograms=True),
            ConvolutionalIterationListener(server, frequency=UI_FREQUENCY),
            clock)
        timed.fit(batches[0])  # the first step, untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed.fit(batches, epochs=UI_STEPS // len(batches))
        ticks = [t0] + clock.times[1:]
        steps = np.diff(ticks) * 1e3
        sampled = [ms for i, ms in enumerate(steps, start=2)
                   if i % UI_FREQUENCY == 0]
        plain = [ms for i, ms in enumerate(steps, start=2)
                 if i % UI_FREQUENCY]
        res = {"steps": UI_STEPS, "batch": ALEXNET_TRAIN_BATCH,
               "samples": len(ups), "score_first": ups[0].score,
               "score_last": ups[-1].score,
               "magnitudes_max_share_of_f32_mean_rtol": worst_mag,
               "f32_mean_rtol_fc6": f32_mean_rtol(9216 * 4096),
               "params_read_per_report": net.num_params(),
               "histograms_per_report": len(ups[-1].param_histograms),
               "remote_updates": len(held_remote),
               "file_updates": len(on_file),
               "endpoint_bytes": sizes,
               "grids_gray_level_max_diff": diffs,
               "held_batch1_max_rel_err": {k: e for k, (_, e)
                                           in held.errors.items()},
               "step_ms_without_report_median": float(np.median(plain)),
               "step_ms_with_report": sampled,
               "report_ms": float(np.mean(sampled) - np.median(plain)),
               "launches_per_step": {k: v for k, v in step.items() if v}}
    finally:
        server.stop()
        remote.stop()
    print(f"[ui] {json.dumps(res)} card={card}")
    return launches


def lenet_batches(n, seed=123):
    """``n`` synthetic MNIST minibatches of 256 (host arrays)."""
    import warnings

    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator

    with warnings.catch_warnings():  # the synthetic-data warning
        warnings.simplefilter("ignore", RuntimeWarning)
        return list(MnistDataSetIterator(
            LENET_TRAIN_BATCH, allow_synthetic=True, seed=seed,
            num_examples=LENET_TRAIN_BATCH * n))


def run_ui_chunk(torch, card):
    """[ui-chunk] LeNet-5 at full width, batch 256, 32 minibatches through
    the default ``fit`` (scan_chunk 16: two chunks of one captured CUDA
    graph) with only ``ConvolutionalIterationListener(frequency=16)``:
    one capture, two replays; the grids are the last minibatch's first
    row through the card's forward (and not the one before's); the
    snapshot is the caller's array, unchanged after another chunk's fill
    rewrote the static input buffer. Returns the launches."""
    import base64

    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.ui import ConvolutionalIterationListener
    from deeplearning4j_tpu_torch.zoo import lenet

    batches = lenet_batches(UI_CHUNK_BATCHES)
    more = lenet_batches(16, seed=7)
    net = MultiLayerNetwork(lenet(), device="cuda").init()
    conv = ConvolutionalIterationListener(frequency=UI_CHUNK_FREQUENCY)
    net.set_listeners(conv)
    dispatch.reset_launch_counts()
    net.fit(batches)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    graphs = list(net._megastep_graphs.values())
    captures = sum(g.metrics is not None for g in graphs)
    replays = sum(g.replays for g in graphs)
    if (captures, replays, [g.k for g in graphs]) != (1, 2, [16]):
        raise RuntimeError(f"[ui-chunk] {captures} captures, {replays} "
                           f"replays, chunks {[g.k for g in graphs]}")
    snap = net._last_features
    if snap is not batches[-1].features:
        raise RuntimeError("[ui-chunk] the snapshot is not the caller's "
                           "last minibatch")
    kept = snap.copy()
    names = net.layer_names
    diffs = grids_against("ui-chunk", conv.last_grids,
                          net.feed_forward(snap[:1]), names)
    # and not the minibatch before the last
    prev = grid_diffs("ui-chunk", conv.last_grids,
                      net.feed_forward(batches[-2].features[:1]), names)
    if max(prev.values()) <= 1:
        raise RuntimeError("[ui-chunk] the grids also match the minibatch "
                           "before the last")
    # another chunk: its fill rewrites the static input buffer
    static = graphs[0].inputs[0]
    net.set_listeners()
    net.fit(more)
    torch.cuda.synchronize()
    if graphs[0].replays != 3 or not np.array_equal(snap, kept) \
            or np.array_equal(static[-1].cpu().numpy(), kept):
        raise RuntimeError("[ui-chunk] the snapshot moved with the static "
                           "buffer's fill")
    shown = base64.b64decode(conv.last_grids[names[0]])
    res = {"minibatches": UI_CHUNK_BATCHES, "rows": LENET_TRAIN_BATCH,
           "captures": captures, "replays_after_fit": replays,
           "grids": sorted(conv.last_grids),
           "grids_gray_level_max_diff": diffs,
           "first_grid_png_bytes": len(shown),
           "snapshot_unchanged_after_fill": True,
           "launches_counted_at_capture": {k: v for k, v in launches.items()
                                           if v}}
    print(f"[ui-chunk] {json.dumps(res)} card={card}")
    return launches


def tsne_points(seed=11):
    """``TSNE_N`` points in ``TSNE_DIM`` dimensions from ``TSNE_CLUSTERS``
    seeded Gaussian clusters (centres of spread 2, unit noise), and their
    cluster labels."""
    rng = np.random.RandomState(seed)
    centres = rng.randn(TSNE_CLUSTERS, TSNE_DIM) * 2.0
    labels = rng.randint(0, TSNE_CLUSTERS, TSNE_N)
    return centres[labels] + rng.randn(TSNE_N, TSNE_DIM), labels


def run_tsne(torch, card):
    """[tsne] ``plot.Tsne`` on the card at N 5,000, d 128 (10 seeded
    clusters), ``max_iter`` 1,000, the defaults otherwise: the joint P on
    the host (f64, timed apart), its first 10 iterations each held to the
    CPU's step from the card's state (y and its increment within 1e-5 of
    y's scale, the gains equal, the KL within rtol 1e-5), then the whole
    fit on the card: its final KL is below that of the first step on the
    true P (a second fit cut at ``stop_lying_iteration + 1``), each
    point's 10 nearest embedded neighbours share its cluster >= 0.9 of
    the time; ms an iteration (CUDA events) and peak memory. The
    iterations are plain torch (the JAX step is jnp, no Pallas kernel):
    no kernel launches."""
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.plot import Tsne

    ptsne = importlib.import_module("deeplearning4j_tpu_torch.plot.tsne")
    x, labels = tsne_points()
    t = Tsne(device="cuda", max_iter=TSNE_ITERS)
    t0 = time.perf_counter()
    p = t._joint_p(x)
    joint_s = time.perf_counter() - t0
    # the first iterations, each step against the CPU's from its state
    rng = np.random.RandomState(t.seed)
    y = torch.from_numpy((rng.randn(TSNE_N, 2) * 1e-4).astype(
        np.float32)).cuda()
    y_inc, gains = torch.zeros_like(y), torch.ones_like(y)
    p_lied = torch.from_numpy((p * t.lie_factor).astype(np.float32))
    worst = {"y": 0.0, "y_inc": 0.0, "kl": 0.0}
    for it in range(TSNE_TWIN_ITERS):
        cur = p_lied  # every twin iteration is in the exaggeration
        host = [a.cpu() for a in (y, y_inc, gains)]
        card_out = ptsne._tsne_step(cur.cuda(), y, y_inc, gains,
                                    t.initial_momentum, t.learning_rate,
                                    want_kl=True)
        ref = ptsne._tsne_step(cur, *host, t.initial_momentum,
                               t.learning_rate, want_kl=True)
        scale = float(ref[0].abs().max())
        worst["y"] = max(worst["y"], float((card_out[0].cpu() - ref[0])
                                           .abs().max()) / scale)
        worst["y_inc"] = max(worst["y_inc"], float(
            (card_out[1].cpu() - ref[1]).abs().max()) / scale)
        worst["kl"] = max(worst["kl"], abs(float(card_out[3]) - float(
            ref[3])) / abs(float(ref[3])))
        if (worst["y"] > TSNE_TWIN_REL or worst["y_inc"] > TSNE_TWIN_REL
                or worst["kl"] > TSNE_TWIN_REL
                or not torch.equal(card_out[2].cpu(), ref[2])):
            raise RuntimeError(f"[tsne] iteration {it} off the CPU's step: "
                               f"{worst}")
        y, y_inc, gains = card_out[:3]
    # the free-running 10 iterations both ways (reported: the gains'
    # sign test makes the trajectory chaotic)
    free = Tsne(device="cuda", max_iter=TSNE_TWIN_ITERS)._fit_p(p)
    free_cpu = Tsne(device="cpu", max_iter=TSNE_TWIN_ITERS)._fit_p(p)
    free_rel = float(np.abs(free - free_cpu).max() / np.abs(free_cpu).max())
    del p_lied
    # the fit on the card
    dispatch.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    emb = t._fit_p(p)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if emb.shape != (TSNE_N, 2) or not np.all(np.isfinite(emb)):
        raise RuntimeError(f"[tsne] embedding {emb.shape}")
    # the KL of the first step on the true P: a second fit cut there
    cut = Tsne(device="cuda", max_iter=t.stop_lying_iteration + 1)
    cut._fit_p(p)
    if not t.kl < cut.kl:
        raise RuntimeError(f"[tsne] the KL did not fall: {cut.kl} at "
                           f"iteration {t.stop_lying_iteration}, final "
                           f"{t.kl}")
    ye = torch.from_numpy(emb).cuda()
    d = torch.cdist(ye, ye)
    d.fill_diagonal_(float("inf"))
    nn = d.topk(10, largest=False).indices.cpu().numpy()
    agree = float((labels[nn] == labels[:, None]).mean())
    if agree < TSNE_MIN_AGREEMENT:
        raise RuntimeError(f"[tsne] 10-NN cluster agreement {agree}")
    res = {"n": TSNE_N, "d": TSNE_DIM, "clusters": TSNE_CLUSTERS,
           "iterations": t.max_iter, "perplexity": t.perplexity,
           "joint_p_host_s": joint_s,
           "ms_per_iteration": start.elapsed_time(end) / t.max_iter,
           "fit_wall_s": wall, "peak_memory_mib": peak / 2 ** 20,
           "kl_after_lie": cut.kl, "kl_final": t.kl,
           "knn10_cluster_agreement": agree,
           "twin_iterations": TSNE_TWIN_ITERS,
           "twin_max_rel": worst, "twin_tolerance": TSNE_TWIN_REL,
           "free_running_10_iterations_rel": free_rel}
    print(f"[tsne] {json.dumps(res)} card={card}")
    return launches


def lenet_reference(torch, batches):
    """A LeNet-5 on the card and its initial weights, fit on ``batches``
    from a ``ListDataSetIterator`` by the default ``fit`` (the reference
    the streamed and stored fits are held to, bitwise)."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import lenet

    ref = MultiLayerNetwork(lenet(), device="cuda").init()
    init = {ln: {pn: t.clone() for pn, t in lp.items()}
            for ln, lp in ref.params.items()}
    ref.fit(ListDataSetIterator(batches))
    torch.cuda.synchronize()
    return ref, init


def run_stream(torch, card):
    """[stream] LeNet-5, batch 256: 20 synthetic MNIST minibatches
    published row by row by an ``NDArrayPublisher`` (a thread) to an
    ``NDArrayConsumer`` over loopback, through
    ``StreamingDataSetIterator`` into the default ``fit`` on the card:
    the parameters bitwise a second net's from the same init fed the same
    minibatches from a list; examples/s and the busy share (the captured
    chunks' device time over the streamed fit's wall); then one POST to
    ``streaming.ModelServer``. Returns the launches."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.streaming import (
        ModelServer,
        NDArrayConsumer,
        NDArrayPublisher,
        StreamingDataSetIterator,
    )
    from deeplearning4j_tpu_torch.zoo import lenet

    batches = lenet_batches(STREAM_BATCHES)
    ref, init = lenet_reference(torch, batches)
    net = MultiLayerNetwork(lenet(), device="cuda").init(params=init)
    consumer = NDArrayConsumer(port=0).listen()
    pub = NDArrayPublisher("127.0.0.1", consumer.port)
    failed = []

    def publish():
        try:
            for ds in batches:
                for row, lab in zip(ds.features, ds.labels):
                    pub.publish(row, labels=lab)
        except Exception as e:  # surfaced after the join
            failed.append(e)

    sender = threading.Thread(target=publish, daemon=True)
    dispatch.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        sender.start()
        net.fit(StreamingDataSetIterator(consumer, LENET_TRAIN_BATCH,
                                         total_batches=STREAM_BATCHES,
                                         timeout=60))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sender.join(timeout=60)
    finally:
        pub.close()
        consumer.close()
    if failed or sender.is_alive():
        raise RuntimeError(f"[stream] the publisher failed: {failed}")
    if net.iteration_count != STREAM_BATCHES or not same_trees(torch, net,
                                                               ref):
        raise RuntimeError("[stream] the streamed fit differs from the "
                           "list's")
    graphs = list(net._megastep_graphs.values())
    dev_ms = sum(events_ms(torch, g.graph.replay, reps=3)[0]
                 for g in graphs)  # one replay of each chunk: every step
    x = batches[0].features[:4]
    server = ModelServer(net, device="cuda")
    server.start()
    try:
        out, post_s = post(server.port, x)
    finally:
        server.stop()
    launches = dispatch.launch_counts()
    np.testing.assert_allclose(out, net.output(x).cpu().numpy(), rtol=1e-4,
                               atol=1e-5)
    res = {"minibatches": STREAM_BATCHES, "rows": LENET_TRAIN_BATCH,
           "examples_per_s": STREAM_BATCHES * LENET_TRAIN_BATCH / wall,
           "wall_s": wall, "chunks": [g.k for g in graphs],
           "device_ms": dev_ms, "device_busy_share": dev_ms / (wall * 1e3),
           "bitwise_list_fit": True, "model_server_post_ms": post_s * 1e3}
    print(f"[stream] {json.dumps(res)} card={card}")
    return launches


def run_cloud_data(torch, card):
    """[cloud-data] [stream]'s 20 minibatches exported by
    ``save_dataset_shards`` into a ``LocalObjectStore`` in a temporary
    directory, then ``CloudDataSetIterator`` into the default ``fit`` on
    the card: bitwise the list-iterator run. Returns the launches."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.cloud import (
        CloudDataSetIterator,
        LocalObjectStore,
        save_dataset_shards,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dispatch
    from deeplearning4j_tpu_torch.zoo import lenet

    batches = lenet_batches(STREAM_BATCHES)
    ref, init = lenet_reference(torch, batches)
    tmp = tempfile.mkdtemp(prefix="dl4j_shards_")
    try:
        store = LocalObjectStore(tmp)
        t0 = time.perf_counter()
        keys = save_dataset_shards(batches, store)
        save_s = time.perf_counter() - t0
        net = MultiLayerNetwork(lenet(), device="cuda").init(params=init)
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        net.fit(CloudDataSetIterator(store))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dispatch.launch_counts()
        shard_bytes = sum(len(store.read(k)) for k in keys)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if net.iteration_count != STREAM_BATCHES or not same_trees(torch, net,
                                                               ref):
        raise RuntimeError("[cloud-data] the stored fit differs from the "
                           "list's")
    res = {"shards": len(keys), "shard_bytes": shard_bytes,
           "save_s": save_s, "fit_wall_s": wall,
           "examples_per_s": STREAM_BATCHES * LENET_TRAIN_BATCH / wall,
           "bitwise_list_fit": True}
    print(f"[cloud-data] {json.dumps(res)} card={card}")
    return launches


def run_native(torch, card):
    """[native] the loader built from the port's source: on seeded IDX
    bytes at MNIST's 60,000 x 28 x 28 and CIFAR-10's 10,000-record batch,
    ``parse_idx3``, ``normalize_u8``, ``assemble_batch`` (the whole
    shuffled set) and ``split_cifar`` bit for bit the numpy route's;
    ``route()`` must be ``"native"``. Prints both routes' times."""
    import struct

    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.ops import dispatch

    t0 = time.perf_counter()
    route = native.route()
    build_s = time.perf_counter() - t0
    if route != "native":
        raise RuntimeError(f"[native] the loader took the {route} route "
                           f"({native._failure})")
    rng = np.random.RandomState(17)
    images = rng.randint(0, 256, (NATIVE_MNIST_ROWS, 784)).astype(np.uint8)
    labels = rng.randint(0, 10, NATIVE_MNIST_ROWS).astype(np.uint8)
    idx = struct.pack(">IIII", 2051, NATIVE_MNIST_ROWS, 28, 28) + \
        images.tobytes()
    perm = rng.permutation(NATIVE_MNIST_ROWS)
    crec = np.concatenate([rng.randint(0, 10, (NATIVE_CIFAR_ROWS, 1)),
                           rng.randint(0, 256, (NATIVE_CIFAR_ROWS, 3072))],
                          1).astype(np.uint8).tobytes()

    def run_all():
        out, ms = {}, {}
        for name, fn in (("parse_idx3", lambda: native.parse_idx3(idx)),
                         ("normalize_u8",
                          lambda: native.normalize_u8(images)),
                         ("assemble_batch", lambda: native.assemble_batch(
                             images, labels, perm, 10)),
                         ("split_cifar", lambda: native.split_cifar(crec))):
            t0 = time.perf_counter()
            out[name] = fn()
            ms[name] = (time.perf_counter() - t0) * 1e3
        return out, ms

    got, native_ms = run_all()
    lib, failure = native._lib, native._failure
    native._lib, native._failure = None, "the numpy route, for comparison"
    try:
        ref, numpy_ms = run_all()
    finally:
        native._lib, native._failure = lib, failure
    for name in got:
        g = got[name] if isinstance(got[name], tuple) else (got[name],)
        r = ref[name] if isinstance(ref[name], tuple) else (ref[name],)
        for a, b in zip(g, r):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise RuntimeError(f"[native] {name} differs from the numpy "
                                   "route")
    if not np.array_equal(got["parse_idx3"], images):
        raise RuntimeError("[native] parse_idx3 is not the images")
    res = {"route": route, "library": native.library_path().name,
           "build_or_load_s": build_s, "mnist_rows": NATIVE_MNIST_ROWS,
           "cifar_rows": NATIVE_CIFAR_ROWS, "native_ms": native_ms,
           "numpy_ms": numpy_ms, "bitwise_numpy_route": True}
    print(f"[native] {json.dumps(res)} card={card}")
    return {k: 0 for k in dispatch.KERNELS}


def periphery_phases():
    """(tag, function) of the host periphery's phases, in
    PERIPHERY_PATHS's order."""
    fns = {"ui": run_ui, "ui-chunk": run_ui_chunk, "tsne": run_tsne,
           "stream": run_stream, "cloud-data": run_cloud_data,
           "native": run_native}
    return [(tag, fns[tag]) for tag in PERIPHERY_PATHS]


def kernel_checks(torch, F, records, half_records, layers):
    """The kernel checks: ``[kernel]`` and ``[layer]`` records appended to
    ``records``, ``half_records`` and ``layers``."""
    from deeplearning4j_tpu_torch.zoo import alexnet, lenet

    gen = torch.Generator(device="cuda").manual_seed(0)
    # the forward shapes of LeNet's serving bucket and training batch, of
    # AlexNet's batch of 64, and the conv listener's batch-1 forward of
    # both ([ui], [ui-chunk])
    for model, conf, batch in (("lenet", lenet(), LENET_BUCKET),
                               ("lenet256", lenet(), LENET_TRAIN_BATCH),
                               ("alexnet", alexnet(), ALEXNET_BATCH),
                               ("lenet-b1", lenet(), 1),
                               ("alexnet-b1", alexnet(), 1)):
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
                          ("alexnet-train", alexnet_train_shapes()),
                          ("googlenet", googlenet_shapes()),
                          ("conv-lstm", conv_lstm_shapes()),
                          ("keras-vgg16", keras_vgg16_shapes())):
        for name, kind_, geo, names in shapes:
            if kind_.startswith("conv_bwd"):
                rec = check_bwd_kernel(torch, model, name, kind_, geo, gen,
                                       KERNEL_WINDOW_MS)
            else:
                rec = check_kernel(torch, F, model, name, kind_, geo, gen,
                                   KERNEL_WINDOW_MS)
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
    # [semb-dp]'s dense layer at a rank's half of the global batch (the
    # tiled route's split plan follows the shape), once a step a rank
    rec = check_kernel(torch, F, "semb-dp", "dense", "matmul_block",
                       {"m": SEMB_BATCH // 2, "k": W2V_DIM, "n": MLP_HIDDEN,
                        "activation": "relu"}, gen)
    rec["launches_per_step"] = 1
    records.append(rec)
    print(f"[kernel] {json.dumps(rec)}")
    check_routes(records)
    # the conv kernels' half-precision variants at ResNet-50's shapes
    half_records.extend(check_half_kernels(torch, F, gen))
    for rec in half_records:
        print(f"[kernel] {json.dumps(rec)}")
    for model, n_in, (T, b, n) in (
            ("charrnn", CHAR_VOCAB, (CHAR_TBPTT, CHAR_BATCH, CHAR_HIDDEN)),
            ("charrnn", CHAR_HIDDEN, (CHAR_TBPTT, CHAR_BATCH, CHAR_HIDDEN)),
            ("saturated", SATURATED[2], SATURATED)):
        rec = lstm_layer_vs_cudnn(torch, model, T, b, n_in, n, gen)
        layers.append(rec)
        print(f"[layer] {json.dumps(rec)}")



def path_launches(kernel, paths, tags=None) -> int:
    """``kernel``'s launches summed over the main paths ``paths`` ({tag:
    launch counts}), or over the ``tags`` among them."""
    return sum(paths[t].get(kernel, 0) for t in (paths if tags is None
                                                  else tags))


def network_launches(kernel, paths, tags=None) -> dict:
    """``kernel``'s launches on each main path of ``tags`` (default
    NETWORK_PATHS) that ran it ({tag: launches})."""
    return {t: paths[t].get(kernel, 0)
            for t in (NETWORK_PATHS if tags is None else tags)
            if paths.get(t, {}).get(kernel, 0)}


# the distribution slice's main paths, listed by path in the kernels line
NEW_PATHS = ("alexnet-tp", "ring-attention", "gpipe", "cluster")

# phases whose main path reads what another phase returns
PHASE_NEEDS = {"transformer-sample": "transformer",
               "transformer-long": "transformer",
               "ring-attention": "transformer", "resnet50-dp": "resnet50"}


def parse_phases(argv):
    """The tags of ``--phases tag[,tag...]`` (None: every phase)."""
    import argparse

    ap = argparse.ArgumentParser(description="smoke run of the port on one "
                                 "NVIDIA card")
    ap.add_argument("--phases", default=None, help="comma-separated phase "
                    "tags to run (default: every phase; 'kernels' is the "
                    "kernel checks, 'nlp' the embeddings phases)")
    args = ap.parse_args(argv)
    if args.phases is None:
        return None
    return {t.strip() for t in args.phases.split(",") if t.strip()}


def launch_dicts(out):
    """Every launch-count dict in a phase's return value."""
    from deeplearning4j_tpu_torch.ops import dispatch

    if isinstance(out, dict):
        if out and set(out) <= set(dispatch.KERNELS):
            return [out]
        return [d for v in out.values() for d in launch_dicts(v)]
    if isinstance(out, (tuple, list)):
        return [d for v in out for d in launch_dicts(v)]
    return []


def summed_launches(out) -> dict:
    """{kernel: launches} of a phase's main path: the launch counts in
    its return value ``out``, summed."""
    total = {}
    for d in launch_dicts(out):
        for k, v in d.items():
            total[k] = total.get(k, 0) + v
    return total


# Each kernel of the kernels line: its source, the TPU kernel it
# replaces, and which of its f32 [kernel] records are the main path's
# launches whose times the line sums: LeNet's serving forward at bucket
# 32 for the forward kernels, one LeNet training step at batch 256 for
# the backward, the char-RNN's chunk (T 50, b 32, n 200) in the variant
# its training runs (the zoo model's peephole cell, the sequence
# forward that writes c_seq), the transformer's training shape, the
# streamed attention at t 16384.
KERNEL_TABLE = {
    "conv_block": ("conv_block.cu", "conv_block.py:104",
                   lambda r: r["shape_of"].startswith("lenet.")),
    "conv_bwd_data": ("conv_bwd.cu", "conv_block.py:104",
                      lambda r: r["shape_of"].startswith("lenet256.")),
    "conv_bwd_w": ("conv_bwd.cu", "conv_block.py:184",
                   lambda r: r["shape_of"].startswith("lenet256.")),
    "matmul_block": ("matmul_block.cu", "matmul_block.py:53",
                     lambda r: r["shape_of"].startswith("lenet.")),
    "lstm_cell": ("lstm_cell.cu", "lstm_cell.py:28",
                  lambda r: (r["shape_of"], r["variant"])
                  == ("charrnn", "peephole")),
    "lstm_seq_fwd": ("lstm_seq.cu", "lstm_cell.py:202",
                     lambda r: (r["shape_of"], r["variant"])
                     == ("charrnn", "c_seq")),
    "lstm_seq_bwd": ("lstm_seq.cu", "lstm_cell.py:217",
                     lambda r: (r["shape_of"], r["variant"])
                     == ("charrnn", "")),
    "flash_attention": ("flash_attention.cu", "flash_attention.py:32",
                        lambda r: r["shape_of"] == "transformer"),
    "flash_attention_streamed": ("flash_attention.cu",
                                 "flash_attention.py:180",
                                 lambda r: r["shape_of"] == "long"),
    "matmul_block_residual": ("matmul_block.cu", "matmul_block.py:59",
                              lambda r: r["shape_of"] == "transformer.ffn2"),
}

# the conv kernels' half-precision variants: ResNet-50's step at batch
# 128 in bf16 (kernel, variant, source, the TPU kernel it replaces)
HALF_TABLE = (("conv_block", "bf16", "conv_block.cu", "conv_block.py:104"),
              ("conv_block", "bf16->f32", "conv_block.cu",
               "conv_block.py:104"),
              ("conv_bwd_w", "bf16", "conv_bwd.cu", "conv_block.py:184"))

# the models whose training step's shapes give per-step keys: each
# shape's time by its launches a step, summed
PER_STEP_MODELS = ("vgg16", "resnet50", "alexnet-train", "googlenet",
                   "conv-lstm", "alexnet-tp", "gpipe", "keras-vgg16")


def kernels_line(records, half_records, layers, paths, half_variants
                 ) -> list:
    """The kernels line of a run: every kernel its phases launched or
    its records hold (a run of every phase: all of them), its launches
    summed over the phases' main paths (``paths``: {tag: {kernel:
    launches}}) and listed on those of NETWORK_PATHS, NEW_PATHS and
    FIT_PATHS, its times those of its main-path records (null where the run made none), and the
    per-step keys of the training steps' records; then the conv kernels'
    half-precision variants (``half_variants``: their launches)."""
    csrc, tpu = "deeplearning4j_tpu_torch/csrc/", "deeplearning4j_tpu/ops/"
    kernels = []
    for k, (src, replaces, is_main) in KERNEL_TABLE.items():
        mine = [r for r in records if r["kernel"] == k
                and r.get("dtype", "float32") == "float32"]
        launches = path_launches(k, paths)
        if not launches and not mine:
            continue
        main = [r for r in mine if is_main(r)]

        # the launches run one after another: the least time is the sum
        # of their bounds, named by the launch that bounds the most
        def total(key, recs=main):
            vals = [r[key] for r in recs]
            return (sum(vals) if vals and None not in vals else None)
        entry = {
            "name": k, "route": "cuda", "source": csrc + src,
            "replaces": tpu + replaces, "launches": launches,
            "launches_by_path": network_launches(
                k, paths, NETWORK_PATHS + NEW_PATHS + FIT_PATHS
                + TUNE_PATHS + PERIPHERY_PATHS),
            "max_abs_err": max((r["max_abs_err"] for r in mine),
                               default=None),
            "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": (max(main, key=lambda r: r["bound_ms"])["bound_by"]
                         if main else None),
            "library_ms": total("library_ms"),
        }
        routes = {r["kernel_route"] for r in main if "kernel_route" in r}
        if routes:  # the kernel route its main path took
            entry["kernel_route"] = "+".join(sorted(routes))
        entry.update(kernel_extras(k, mine, main, layers))
        kernels.append(entry)
    for k, variant, src, replaces in HALF_TABLE:
        mine = [r for r in half_records
                if r["kernel"] == k and r["variant"] == variant]
        if not mine:
            continue

        def per_step_sum(key, recs=mine):
            return sum(r[key] * r["launches_per_step"] for r in recs)
        kernels.append({
            "name": f"{k}[{variant}]", "route": "cuda",
            "source": csrc + src, "replaces": tpu + replaces,
            "launches": half_variants.get(f"{k}[{variant}]", 0),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": per_step_sum("kernel_ms"), "plain_ms": per_step_sum("plain_ms"),
            "bound_ms": per_step_sum("bound_ms"),
            "bound_by": max(mine, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": per_step_sum("library_ms"),
            "bound_fp32_simt_ms": per_step_sum("bound_fp32_simt_ms"),
            "shape_of": "resnet50-bf16 step, batch 128",
            "launches_per_step": sum(r["launches_per_step"] for r in mine),
            "kernel_route": "+".join(sorted({r["kernel_route"]
                                             for r in mine}))})
    return kernels


def kernel_extras(k, mine, main, layers) -> dict:
    """The keys of ``k``'s entry beside the contract's, from the records
    this run made: the per-step sums of PER_STEP_MODELS' training steps,
    AlexNet's five convs at batch 64, dW by LeNet layer, the
    transformer's input projection, the embedding MLP's and [semb-dp]'s
    dense layer, and the LSTM kernels' layer-level times beside
    torch.nn.LSTM's (cuDNN, input projection included, n_in 200) as
    their library_ms."""
    extra = {}
    for model in PER_STEP_MODELS:
        recs = [r for r in mine if r["shape_of"].startswith(model + ".")]
        if not recs:
            continue
        tag = model.replace("-", "_")
        extra.update({f"{tag}_{key}_per_step": sum(
            r[key] * r["launches_per_step"] for r in recs)
            for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")})
        extra.update({f"{tag}_launches_per_step": sum(
            r["launches_per_step"] for r in recs),
            f"{tag}_route": "+".join(
                sorted({r["kernel_route"] for r in recs}))})
    for model in ("alexnet-b1", "lenet-b1"):  # the conv listener's forward
        recs = [r for r in mine if r["shape_of"].startswith(model + ".")]
        if recs and k in ("conv_block", "matmul_block"):
            tag = model.replace("-", "_")
            extra.update({f"{tag}_{key}": sum(r[key] for r in recs)
                          for key in ("kernel_ms", "plain_ms", "library_ms",
                                      "bound_ms")})
            extra[f"{tag}_route"] = "+".join(sorted(
                {r["kernel_route"] for r in recs}))
    alex = [r for r in mine if r["shape_of"].startswith("alexnet.")]
    if k == "conv_block" and alex:
        extra.update(alexnet_route="+".join(sorted(
            {r["kernel_route"] for r in alex})),
            alexnet_ms=sum(r["kernel_ms"] for r in alex),
            alexnet_library_ms=sum(r["library_ms"] for r in alex),
            alexnet_bound_ms=sum(r["bound_ms"] for r in alex))
    if k == "conv_bwd_w":  # each layer of the step, library beside
        for r in main:
            layer = r["shape_of"].split(".")[1]
            extra.update({f"{layer}_ms": r["kernel_ms"],
                          f"{layer}_library_ms": r["library_ms"],
                          f"{layer}_bound_ms": r["bound_ms"]})
    if k == "matmul_block":
        by_shape = {r["shape_of"]: r for r in mine}
        tx_in = by_shape.get("transformer.input")
        if tx_in:
            extra.update(transformer_route=tx_in["kernel_route"],
                         transformer_ms=tx_in["kernel_ms"],
                         transformer_library_ms=tx_in["library_ms"])
        # the embedding MLP's dense layer (one launch a step) and
        # [semb-dp]'s, at a rank's half batch (one a step a rank)
        for shape, tag in (("embedding-mlp.dense", "embedding_mlp"),
                           ("semb-dp.dense", "semb_dp")):
            if shape in by_shape:
                extra.update({f"{tag}_{key}": by_shape[shape][key]
                              for key in ("kernel_route", "kernel_ms",
                                          "plain_ms", "library_ms",
                                          "bound_ms", "max_abs_err")})
    cudnn = next((r for r in layers if r["shape_of"] == "charrnn"
                  and r["n_in"] == CHAR_HIDDEN), None)
    if k.startswith("lstm_seq") and cudnn:
        side = k[-3:]  # fwd / bwd
        extra.update(library_ms=cudnn[f"cudnn_{side}_ms"],
                     **{f"port_{side}_ms": cudnn[f"port_{side}_ms"]})
    if k == "lstm_cell":
        extra["library_ms"] = None
    return extra


def main(argv=None) -> int:
    # a fatal signal (a crash in native code) prints every thread's
    # Python stack on stderr, so the phase it hit is named
    faulthandler.enable(all_threads=True)
    phases = parse_phases(sys.argv[1:] if argv is None else argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[env] card: {card}")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    print(f"[env] kernel build: {build_s:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds else 0:.2f} s;"
          f" 0 = library already built)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from collections import Counter

    needed = None if phases is None else set(phases) | {
        PHASE_NEEDS[t] for t in phases if t in PHASE_NEEDS}

    def wanted(tag) -> bool:
        return needed is None or tag in needed

    if phases is not None:
        print(f"[env] phases: {sorted(phases)} (with {sorted(needed)})")
    records, half_records, layers = [], [], []
    if wanted("kernels"):
        kernel_checks(torch, F, records, half_records, layers)
    print(f"[kernel-checks] phase "
          f"{time.perf_counter() - t_start - build_s:.1f} s")

    paths = {}  # {tag: the launches of its main path}

    def phase(tag, fn, *args, default=None, **kw):
        """``fn(torch, card, ...)``, its wall time printed; a phase not
        selected returns ``default`` (no launches)."""
        if not wanted(tag):
            return Counter() if default is None else default
        t0 = time.perf_counter()
        out = fn(torch, card, *args, **kw)
        print(f"[{tag}] phase {time.perf_counter() - t0:.1f} s")
        paths[tag] = summed_launches(out)
        return out

    phase("serve", serve_lenet)
    phase("train", train_lenet)
    phase("alexnet", run_alexnet)
    phase("alexnet-train", run_alexnet_train, records)
    ids, alphabet = survey_corpus()
    phase("charrnn", run_charrnn, True, ids, alphabet)
    phase("charrnn-seq", run_charrnn, False, ids, alphabet)
    tokens = survey_bytes()
    lm, _ = phase("transformer", run_transformer, tokens,
                  default=(None, Counter()))
    phase("transformer-twin", run_transformer_twin, tokens)
    phase("transformer-sample", sample_transformer, lm, tokens, seed=7)
    phase("transformer-long", run_transformer_long, lm, tokens, seed=8)
    phase("vgg16", run_vgg16)
    phase("conv-bn", run_conv_bn)
    _, resnet_init, resnet_data = phase("resnet50", run_resnet50,
                                        default=(Counter(), None, None))
    phase("resnet50-dp", run_resnet50_dp, resnet_init, resnet_data)
    del resnet_init, resnet_data
    # half-precision training (each returns launches and variant counts)
    half_paths = [phase("resnet50-bf16", run_resnet50_bf16,
                        default=(Counter(), {})),
                  phase("vgg16-bf16", run_vgg16_bf16,
                        default=(Counter(), {})),
                  phase("transformer-bf16", run_transformer_bf16, tokens,
                        default=(Counter(), {})),
                  phase("f16-loss-scale", run_f16_loss_scale, tokens,
                        default=(Counter(), {}))]
    phase("guard", run_guard)
    phase("megastep", run_megastep)
    # the training runtime (resume, preemption, prefetch, validation, the
    # window, the trainer's megastep) under ResNet-50, and the rollback
    phase("resnet50-runtime", run_resnet50_runtime)
    phase("lenet-rollback", run_lenet_rollback)
    # the scan path: device-cached chunks and the fused TBPTT scan, each
    # against the per-step loop; then the observability around them
    phase("lenet-cached", run_lenet_cached)
    phase("vgg16-cached", run_vgg16_cached)
    phase("charrnn-fused", run_charrnn_fused, True, ids)
    phase("charrnn-seq-fused", run_charrnn_fused, False, ids)
    phase("telemetry", run_telemetry)
    # the elastic control plane under ResNet-50 and LeNet-5, the default
    # fit of the large models, the serving tier, then the
    # continuous-learning loop, early stopping and evaluate
    for tag, fn, args in (("elastic-resnet50", run_elastic_resnet50, ()),
                          ("elastic-storm", run_elastic_storm, ()),
                          ("default-fit", run_default_fit, (tokens,)),
                          ("fleet", run_fleet, ()),
                          ("aot-restart", run_aot_restart, (build_s,)),
                          ("loop", run_loop, ()),
                          ("earlystop", run_earlystop, ()),
                          ("evaluate", run_evaluate, ())):
        phase(tag, fn, *args)
    # the networks of the MoE / GoogLeNet / graph-RNN slice
    for tag, fn, args in network_phases(records, tokens, ids):
        phase(tag, fn, *args)
    # the distribution slice's last raises: tensor parallelism, the ring
    # and GPipe on one spawned world of two ranks, the cluster master here
    world = [t for t in WORLD_PHASES if wanted(t)]
    if world:
        paths.update(run_rank_world(torch, card, records, lm, tokens, world))
    phase("cluster", run_cluster)
    # the rest of fit: pretraining and the line-search solvers
    for tag, fn in fit_phases():
        phase(tag, fn)
    # Keras's VGG-16 imported at 224 x 224, then the kernel tuner on it
    for tag, fn, args in tune_phases():
        phase(tag, fn, *args)
    # the host periphery: the training UI, t-SNE, the NDArray stream,
    # object-store shards and the native loader
    for tag, fn in periphery_phases():
        phase(tag, fn)
    if wanted("nlp"):
        paths["nlp"] = summed_launches(run_nlp(torch, card))
    # the row-sharded trainer on two ranks (after every phase that forms
    # a world in this process)
    phase("semb-dp", run_semb_dp)
    half_variants = {}
    for _, variants in half_paths:
        for k, v in variants.items():
            half_variants[k] = half_variants.get(k, 0) + v
    kernels = kernels_line(records, half_records, layers, paths,
                           half_variants)
    if phases is None:  # every kernel launched and timed at its main path
        names = {e["name"]: e for e in kernels}
        want = list(KERNEL_TABLE) + [f"{k}[{v}]" for k, v, _, _ in HALF_TABLE]
        short = [k for k in want if k not in names or not names[k]["launches"]
                 or names[k]["ms"] is None]
        if short:
            raise RuntimeError(f"kernels not launched or not timed at "
                               f"their main path: {short}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
