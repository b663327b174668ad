#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on
one NVIDIA card, the quickest proof that the port still starts there.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits
non-zero (nothing is caught):

1. environment: the card's name and power limit (``nvidia-smi``), the
   PyTorch / CUDA versions, and the build of the hand-written kernels
   from ``deeplearning4j_tpu_torch/csrc`` (timed);
2. kernels: every kernel at every shape the slice gives it (LeNet-5's
   two convs and dense layer at the largest serving bucket, 32 rows;
   AlexNet's five convs and two dense layers at batch 64), held against
   its plain PyTorch version on the card, with TF32 off on both sides,
   and timed (CUDA graphs of back-to-back launches, CUDA events) beside
   its plain version, one PyTorch library call that computes the same
   function (``library_ms``) and its bound on an H100 SXM;
3. serving (the main path): ``ModelServer`` with a full-width LeNet-5
   (random weights from a seed) on the card answers solo and concurrent
   ``/predict`` requests; every answer is checked against the plain
   path (the same weights on the CPU), the kernels' launch counters are
   zeroed just before and read just after, and latency and throughput
   are printed;
4. AlexNet at 224x224x3 / 1000 classes through
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
    if per_forward != {"conv_block": 5, "matmul_block": 2}:
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

    from deeplearning4j_tpu_torch.ops import _build, dispatch
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
                               ("alexnet", alexnet(), ALEXNET_BATCH)):
        for name, kind_, geo in kernel_shapes(conf, batch):
            rec = check_kernel(torch, F, model, name, kind_, geo, gen)
            records.append(rec)
            print(f"[kernel] {json.dumps(rec)}")

    launches = serve_lenet(torch, card)
    run_alexnet(torch, card)

    kernels = []
    sources = {"conv_block": ("deeplearning4j_tpu_torch/csrc/conv_block.cu",
                              "deeplearning4j_tpu/ops/conv_block.py:104"),
               "matmul_block": ("deeplearning4j_tpu_torch/csrc/"
                                "matmul_block.cu",
                                "deeplearning4j_tpu/ops/matmul_block.py:53")}
    for k, (src, replaces) in sources.items():
        mine = [r for r in records if r["kernel"] == k]
        # times: one LeNet forward's launches of this kernel at the
        # serving bucket (the main path); error: every shape checked
        main = [r for r in mine if r["shape_of"].startswith("lenet.")]
        flops = sum(r["gflop"] for r in main) * 1e9
        nbytes = sum(r["mb"] for r in main) * 1e6
        bound_ms, bound_by = bound(flops, nbytes)
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k],
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
