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
   dW, so the stride-4 and padded geometry run);
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
   timed.

The last lines are the card line, one JSON object with the per-kernel
numbers, and ``{"ok": true, "device": {...}}``. Exits non-zero without
a CUDA device, and when the port's package is not beside it.
"""

import http.client
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
                activation=act)))
        elif isinstance(layer, DenseLayer) and act in SUPPORTED_EPILOGUES:
            n_dense += 1
            out.append((f"dense{n_dense}", "matmul_block", dict(
                m=batch, k=layer.n_in, n=layer.n_out, activation=act)))
        it = layer.output_type(it)
    return out


def backward_shapes(conf, batch):
    """(name, kind, geometry) of the backward launches one training step
    of ``conf`` at ``batch`` rows makes: dW for every fused conv, dx for
    every one but the first (the network's input needs no gradient)."""
    out = []
    for name, kind, geo in kernel_shapes(conf, batch):
        if kind != "conv_block":
            continue
        if name != "conv1":
            out.append((name, "conv_bwd_data", geo))
        out.append((name, "conv_bwd_w", geo))
    return out


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


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
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
    return {"kernel": kind, "shape_of": f"{model}.{name}", "x": list(xs),
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
            return torch.relu_(F.conv2d(x, w, b, stride=geo["stride"],
                                        padding=geo["padding"]))
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
    if act != "relu":
        raise ValueError(f"{name}: library yardstick assumes relu, got {act}")
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
    return {"kernel": kind, "shape_of": f"{model}.{name}", **shape,
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
    """The same network and weights on the CPU: the plain path."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return MultiLayerNetwork(model.conf, device="cpu").init(params={
        ln: {pn: t.cpu() for pn, t in lp.items()}
        for ln, lp in model.params.items()})


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
    expected = {"conv_block": 4, "conv_bwd_data": 1, "conv_bwd_w": 2,
                "matmul_block": 1}
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
    if per_forward != {"conv_block": 5, "conv_bwd_data": 0, "conv_bwd_w": 0,
                       "matmul_block": 2}:
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
        for name, kind_, geo in backward_shapes(conf, batch):
            rec = check_bwd_kernel(torch, model, name, kind_, geo, gen)
            records.append(rec)
            print(f"[kernel] {json.dumps(rec)}")

    served = serve_lenet(torch, card)
    trained = train_lenet(torch, card)
    run_alexnet(torch, card)

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
        flops = sum(r["gflop"] for r in main) * 1e9
        nbytes = sum(r["mb"] for r in main) * 1e6
        bound_ms, bound_by = bound(flops, nbytes)
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": served[k] + trained[k],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["kernel_ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sum(r["library_ms"] for r in main),
        })
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
