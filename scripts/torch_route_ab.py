#!/usr/bin/env python3
"""The routed and redesigned kernels of the port at their main-path
shapes on one CUDA card: the conv forward at LeNet-5's convs (the
serving bucket of 32 and the training batch of 256) and AlexNet's five
(batch 64), the LSTM cell at the char-RNN's step (b 32, n 200, with
peepholes), its sampling launch (b 1) and bench.py's saturated shape
(b 256, n 1024), ``conv_bwd_data`` at LeNet-5's conv2 (batch 256, the
resident route), ``conv_bwd_w`` at LeNet-5's conv1 and conv2 (batch
256, the image-resident route), the dense kernel at the transformer's
input projection and, with the residual, its FFN's second product (the
wide route), flash attention's two entries at the transformer's
shapes (f32, causal: b·h 192 × t 512 for ``flash_attention``, b·h 12 × t
16384 for ``flash_attention_streamed``), and the LSTM sequence kernels
at the char-RNN's TBPTT chunk (T 50, b 32, n 200; the cluster route),
its T 1 sampling launch (b 1, the c_seq-free forward) and bench.py's
saturated shape (T 128, b 256, n 1024; the grid route).

    python3 scripts/torch_route_ab.py --check
    python3 scripts/torch_route_ab.py --sweep
    python3 scripts/torch_route_ab.py --parent DIR [--rounds N]

``--check`` prints what ``nvcc -Xptxas -v`` reports for the kernel
sources (registers, shared memory, spills), then runs each kernel once
at each shape (in processes of CHECK_CHUNK shapes), holds it against
its plain PyTorch version and a second launch (bitwise), and prints one
JSON line with the device time of each CUDA kernel one call launches
(``torch.profiler``).

``--sweep`` times the conv forward at each of its shapes on every route
and wide tile, both conv backward kernels on each of their routes (the
resident dx route at several channel groups, the image-resident dW
route also past the rule's cap on the images a block walks), and the
cell on the slice route and on latency plans of several rows and units
a block, each forced through the wrapper (the route function patched),
in turns, each held to its plain version, with the library call and the
bound beside the convs, and prints one JSON line: the data the route
rules are fitted to. The conv shapes include every distinct kernel
shape of VGG-16's and ResNet-50's training steps at batch 128 and
AlexNet's (``alexnet-train``);
``--only PREFIX`` keeps the shapes whose name starts so (``vgg16``,
``resnet50``, ``alexnet-train``), ``--kind KERNEL`` one kernel's
shapes. ``--dtype bfloat16`` (or ``float16``) sweeps the conv
forward and ``conv_bwd_w`` on a half image instead (``conv_bwd_data``
is f32 in every dtype), the library calls in the same dtype.

``--groups`` times the resident ``conv_bwd_data`` kernel at LeNet-5's
conv2 with several channel-group sizes (20: one group of all the
channels; 10 and 4: two and five groups, smaller blocks) and tap-group
counts (more threads a block), in turns, the launch made directly, and
prints one JSON line.

``--rows`` times the LSTM sequence kernels' cluster route at the
char-RNN's chunk (T 50, b 32, n 200) for each batch-row count a cluster
(1, 2, 4, 8: 32, 16, 8 and 4 clusters of 8 blocks), the launch made
directly, with the clusters of that shape the card holds at once, and
prints one JSON line.

``--parent DIR`` times the kernels of a second tree (an unpacked
``git archive`` of another commit, whose ``deeplearning4j_tpu_torch``
takes the same calls) against this one's, in turns (parent, this, this,
parent, ``--rounds`` times), one process a turn, with CUDA events around
CUDA-graph replays, and the PyTorch library call beside each
(``F.conv2d`` + relu, ``conv2d_input``, ``conv2d_weight``; ``addmm``
plus the residual add; ``scaled_dot_product_attention``; for the LSTM
sequence kernels ``torch.nn.LSTM``'s whole layer, cuDNN, forward or
backward; none for the cell, which no one PyTorch call computes). The
LSTM sequence kernels and their library layer are timed on the device
clock instead (``torch.profiler``'s sum of the device activities of 5
calls: a grid-route launch's barrier memset included), with the host's
time to enqueue one call beside (``host_ms``, the cell's too). TF32 is
off. Prints one JSON line per turn and one with the medians and the
card's name and power limit. Exits non-zero without a card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, kind, shape): LeNet-5's convs at the training batch; the
# transformer LM (d 768, batch 16 x t 512) input projection and FFN2;
# its attention (12 heads of 64) at t 512 and, streamed, at t 16384
SHAPES = (
    ("lenet.conv1", "conv_block", ((32, 1, 28, 28), (20, 1, 5, 5), 1, 0)),
    ("lenet.conv2", "conv_block", ((32, 20, 12, 12), (50, 20, 5, 5), 1, 0)),
    ("lenet256.conv1", "conv_block", ((256, 1, 28, 28), (20, 1, 5, 5), 1,
                                      0)),
    ("lenet256.conv2", "conv_block", ((256, 20, 12, 12), (50, 20, 5, 5), 1,
                                      0)),
    ("alexnet.conv1", "conv_block", ((64, 3, 224, 224), (96, 3, 11, 11), 4,
                                     2)),
    ("alexnet.conv2", "conv_block", ((64, 96, 27, 27), (256, 96, 5, 5), 1,
                                     2)),
    ("alexnet.conv3", "conv_block", ((64, 256, 13, 13), (384, 256, 3, 3), 1,
                                     1)),
    ("alexnet.conv4", "conv_block", ((64, 384, 13, 13), (384, 384, 3, 3), 1,
                                     1)),
    ("alexnet.conv5", "conv_block", ((64, 384, 13, 13), (256, 384, 3, 3), 1,
                                     1)),
    ("charrnn", "lstm_cell", (32, 200, True)),
    ("charrnn-sample", "lstm_cell", (1, 200, True)),
    ("saturated", "lstm_cell", (256, 1024, True)),
    ("lenet256.conv2", "conv_bwd_data", ((256, 20, 12, 12), (50, 20, 5, 5))),
    ("lenet256.conv1", "conv_bwd_w", ((256, 1, 28, 28), (20, 1, 5, 5))),
    ("lenet256.conv2", "conv_bwd_w", ((256, 20, 12, 12), (50, 20, 5, 5))),
    ("transformer.input", "matmul_block", (8192, 256, 768, False)),
    ("transformer.ffn2", "matmul_block_residual", (8192, 3072, 768, True)),
    ("transformer", "flash_attention", (16, 12, 512, 64)),
    ("long", "flash_attention_streamed", (1, 12, 16384, 64)),
    ("charrnn", "lstm_seq_fwd", (50, 32, 200, True)),
    ("charrnn", "lstm_seq_bwd", (50, 32, 200, True)),
    ("charrnn-sample", "lstm_seq_fwd", (1, 1, 200, False)),
    ("saturated", "lstm_seq_fwd", (128, 256, 1024, True)),
    ("saturated", "lstm_seq_bwd", (128, 256, 1024, True)),
)
SOURCES = ("conv_block.cu", "matmul_block.cu", "conv_bwd.cu",
           "flash_attention.cu", "lstm_cell.cu", "lstm_seq.cu")


def _lstm_operands(torch, kind, shape, gen):
    """(kernel, plain, library) calls of an LSTM sequence kernel at (T,
    b, n); library: ``torch.nn.LSTM(n, n)``'s layer (cuDNN), forward, or
    the backward of a retained graph (dx and every weight's gradient)."""
    from deeplearning4j_tpu_torch.ops import (
        lstm_seq_bwd,
        lstm_seq_bwd_reference,
        lstm_seq_fwd,
        lstm_seq_fwd_reference,
    )

    T, b, n, save = shape
    dev = torch.device("cuda")

    def randn(*dims, scale=1.0):
        return torch.randn(dims, device=dev, generator=gen) * scale

    xproj = randn(T, b, 4 * n, scale=0.5)
    h0, c0 = randn(b, n, scale=0.1), randn(b, n, scale=0.1)
    rw = randn(n, 4 * n, scale=n ** -0.5)
    lstm = torch.nn.LSTM(n, n).to(dev)
    x = randn(T, b, n)
    if kind == "lstm_seq_fwd":
        def layer_fwd():
            with torch.inference_mode():
                return lstm(x)
        return (lambda: lstm_seq_fwd(xproj, h0, c0, rw, save),
                lambda: lstm_seq_fwd_reference(xproj, h0, c0, rw, save),
                layer_fwd)
    hseq, cseq, _, _ = lstm_seq_fwd_reference(xproj, h0, c0, rw)
    hprev = torch.cat([h0[None], hseq[:-1]]).contiguous()
    cprev = torch.cat([c0[None], cseq[:-1]]).contiguous()
    args = (xproj, hprev, cprev, cseq, rw, randn(T, b, n), randn(b, n),
            randn(b, n))
    xl = x.clone().requires_grad_(True)
    with torch.enable_grad():
        out = lstm(xl)[0]
    g = randn(T, b, n)
    return (lambda: lstm_seq_bwd(*args),
            lambda: lstm_seq_bwd_reference(*args),
            lambda: torch.autograd.grad(out, [xl, *lstm.parameters()], g,
                                        retain_graph=True))


def _conv_operands(torch, shape, gen, dtype=None):
    """(kernel, plain, library) calls of the conv forward at (x shape, w
    shape, stride, padding), relu epilogue, in ``dtype`` (default f32);
    library: ``F.conv2d`` + relu (cuDNN, TF32 off)."""
    from deeplearning4j_tpu_torch.ops import conv_block, conv_block_reference

    xs, ws, st, pad = shape
    dev = torch.device("cuda")
    dtype = dtype or torch.float32
    x = torch.randn(xs, device=dev, generator=gen).to(dtype)
    w = (torch.randn(ws, device=dev, generator=gen) / (
        ws[1] * ws[2] * ws[3]) ** 0.5).to(dtype)
    b = 0.1 * torch.randn(ws[0], device=dev, generator=gen)
    kw = dict(stride=st, padding=pad, activation="relu")
    return (lambda: conv_block(x, w, b, **kw),
            lambda: conv_block_reference(x, w, b, **kw),
            lambda: torch.relu_(torch.nn.functional.conv2d(
                x, w, b.to(dtype), stride=st, padding=pad)))


def _cell_operands(torch, shape, gen):
    """(kernel, plain, None) calls of one LSTM step at (b, n, peephole):
    no one PyTorch call computes this cell."""
    from deeplearning4j_tpu_torch.ops import lstm_cell, lstm_cell_reference

    b, n, peephole = shape
    dev = torch.device("cuda")

    def randn(*dims, scale=1.0):
        return torch.randn(dims, device=dev, generator=gen) * scale

    xproj = randn(b, 4 * n, scale=0.5)
    h, c = randn(b, n, scale=0.1), randn(b, n, scale=0.1)
    rw = randn(n, 4 * n, scale=n ** -0.5)
    peeps = (tuple(randn(n, scale=0.1) for _ in range(3)) if peephole
             else None)
    return (lambda: lstm_cell(xproj, h, c, rw, peeps),
            lambda: lstm_cell_reference(xproj, h, c, rw, peeps), None)


def _operands(torch, kind, shape, gen, dtype=None):
    """(kernel, plain, library) calls of ``kind`` at ``shape``; the conv
    forward's operands and ``conv_bwd_w``'s image in ``dtype`` (default
    f32)."""
    import importlib

    from deeplearning4j_tpu_torch.ops import (
        conv_bwd_data,
        conv_bwd_data_reference,
        conv_bwd_w,
        conv_bwd_w_reference,
        matmul_block,
        matmul_block_reference,
    )

    dev = torch.device("cuda")
    if kind == "lstm_cell":
        return _cell_operands(torch, shape, gen)
    if kind.startswith("lstm"):
        return _lstm_operands(torch, kind, shape, gen)
    if kind == "conv_block":
        return _conv_operands(torch, shape, gen, dtype)
    if kind.startswith("flash"):
        fa = importlib.import_module(
            "deeplearning4j_tpu_torch.ops.flash_attention")
        q, k, v = (torch.randn(shape, device=dev, generator=gen)
                   for _ in range(3))
        streamed = kind == "flash_attention_streamed"
        return (lambda: fa._kernel_forward(q, k, v, True, streamed),
                lambda: fa.flash_attention_reference(q, k, v, True,
                                                     streamed=streamed),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True))
    if kind.startswith("conv"):
        xs, ws, st, pad = _bwd_shape(shape)
        oh = (xs[2] + 2 * pad[0] - ws[2]) // st[0] + 1
        ow = (xs[3] + 2 * pad[1] - ws[3]) // st[1] + 1
        x = torch.randn(xs, device=dev, generator=gen)
        w = torch.randn(ws, device=dev, generator=gen) / (
            ws[1] * ws[2] * ws[3]) ** 0.5
        dacc = torch.randn((xs[0], ws[0], oh, ow), device=dev, generator=gen)
        if kind == "conv_bwd_w":
            if dtype is not None:  # a half image, the library in its dtype
                x, dacc_lib = x.to(dtype), dacc.to(dtype)
            else:
                dacc_lib = dacc
            return (lambda: conv_bwd_w(x, dacc, ws, st, pad),
                    lambda: conv_bwd_w_reference(x, dacc, ws, st, pad),
                    lambda: torch.nn.grad.conv2d_weight(
                        x, ws, dacc_lib, stride=st, padding=pad))
        return (lambda: conv_bwd_data(dacc, w, xs[2:], st, pad),
                lambda: conv_bwd_data_reference(dacc, w, xs[2:], st, pad),
                lambda: torch.nn.grad.conv2d_input(xs, w, dacc, stride=st,
                                                   padding=pad))
    m, k, n, with_res = shape
    x = torch.randn(m, k, device=dev, generator=gen)
    w = torch.randn(k, n, device=dev, generator=gen) / k ** 0.5
    b = 0.1 * torch.randn(n, device=dev, generator=gen)
    r = torch.randn(m, n, device=dev, generator=gen) if with_res else None

    def library():
        y = torch.addmm(b, x, w)
        return y.add_(r) if with_res else y
    return (lambda: matmul_block(x, w, b, r),
            lambda: matmul_block_reference(x, w, b, r), library)


def _bwd_shape(shape):
    """A backward shape, (x shape, w shape) or (x shape, w shape,
    stride, padding), as the latter with pairs."""
    xs, ws, st, pad = shape if len(shape) == 4 else (*shape, 1, 0)
    pair = (lambda v: tuple(v) if isinstance(v, (tuple, list))
            else (int(v), int(v)))
    return tuple(xs), tuple(ws), pair(st), pair(pad)


def model_sweep_shapes():
    """(name, kind, shape) of every distinct kernel shape of VGG-16's
    training step at batch 128 (chip_smoke.vgg_shapes), ResNet-50's at
    224 x 224, batch 128 (chip_smoke.resnet_shapes) and AlexNet's at 224 x
    224, batch 128 (chip_smoke.alexnet_train_shapes), the dense layers
    left out (no routed choice is swept for them)."""
    from chip_smoke import alexnet_train_shapes, resnet_shapes, vgg_shapes

    return [(f"{model}.{name}", kind, (tuple(geo["x"]), tuple(geo["w"]),
                                       tuple(geo["stride"]),
                                       tuple(geo["padding"])))
            for model, shapes in (("vgg16", vgg_shapes()),
                                  ("resnet50", resnet_shapes()),
                                  ("alexnet-train", alexnet_train_shapes()))
            for name, kind, geo, _ in shapes if kind != "matmul_block"]


def _route(kind, shape):
    from deeplearning4j_tpu_torch.ops.conv_block import (
        conv_block_route,
        conv_bwd_data_route,
        conv_bwd_w_route,
    )
    from deeplearning4j_tpu_torch.ops.lstm_cell import (
        lstm_cell_route,
        lstm_seq_route,
    )
    from deeplearning4j_tpu_torch.ops.matmul_block import matmul_route

    if kind == "lstm_cell":
        return lstm_cell_route(shape[0], shape[1]).route
    if kind == "conv_block":
        (n, c, h, w), (o, _, kh, kw), st, pad = shape
        return conv_block_route(n, c, h, w, o, kh, kw, st, pad).route
    if kind.startswith("lstm"):
        return lstm_seq_route(shape[0], shape[1], shape[2],
                              kind == "lstm_seq_bwd").route
    if kind.startswith("flash"):
        return "single"
    if kind.startswith("conv"):
        (n, c, h, w), (o, _, kh, kw), st, pad = _bwd_shape(shape)
        pick = conv_bwd_w_route if kind == "conv_bwd_w" else \
            conv_bwd_data_route
        return pick(n, c, h, w, o, kh, kw, st, pad).route
    return matmul_route(shape[0], shape[2])


def _ptxas_report():
    """``nvcc -Xptxas -v`` of the routed kernels' sources, one line per
    kernel: name, registers, shared memory, spill stores / loads."""
    from deeplearning4j_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for src in SOURCES:
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(_build.CSRC_DIR / src), "-o", str(out_dir / (src + ".o"))],
            capture_output=True, text=True, timeout=600, check=True)
        kernel = None
        for line in (proc.stdout + proc.stderr).splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif kernel and ("registers" in line or "spill" in line):
                lines.append(f"[ptxas] {src} {kernel}: {line.strip()}")
    return lines


# shapes a --check process profiles: past about twenty profiler sessions
# in one process the CUDA activities came back empty
CHECK_CHUNK = 12


def check(torch):
    for line in _ptxas_report():
        print(line, flush=True)
    for start in range(0, len(SHAPES), CHECK_CHUNK):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--check-from", str(start)], cwd=HERE,
                            timeout=900).returncode
        if rc != 0:
            return rc
    return 0


def check_from(torch, start):
    """--check's held-and-timed launches of SHAPES[start:start +
    CHECK_CHUNK]."""
    from chip_smoke import profiled_device_ms
    from deeplearning4j_tpu_torch.ops import dispatch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for name, kind, shape in SHAPES[start:start + CHECK_CHUNK]:
        kernel, plain, library = _operands(torch, kind, shape, gen)
        dispatch.reset_launch_counts()
        lstm = kind.startswith("lstm")
        with torch.inference_mode():
            got, again, ref = kernel(), kernel(), plain()
            # the LSTM layer runs on weights of its own: timed, not held
            lib = None if lstm else library()
        torch.cuda.synchronize()
        launches = dispatch.launch_counts()[kind]
        with torch.inference_mode():
            _, by_kernel = profiled_device_ms(torch, kernel)
        # the LSTM kernels return several outputs (c_seq may be None):
        # each is held to its own scale
        outs = [(a, r, a2) for a, r, a2 in (zip(got, ref, again) if lstm
                                            else [(got, ref, again)])
                if r is not None]
        rec = {"shape_of": name, "kernel": kind,
               "kernel_route": _route(kind, shape),
               "launches": launches,
               "bitwise_repeat": all(torch.equal(a, a2)
                                     for a, _, a2 in outs),
               "max_abs_err": max(float((a - r).abs().max())
                                  for a, r, _ in outs),
               "rel_err": max(float((a - r).abs().max())
                              / max(float(r.abs().max()), 1.0)
                              for a, r, _ in outs),
               "library_max_abs_err": None if lib is None
               else float((got - lib).abs().max()),
               "scale": max(max(float(r.abs().max()), 1.0)
                            for _, r, _ in outs),
               "close": kind != "conv_block" or all(
                   torch.allclose(a, r, rtol=1e-4, atol=1e-4)
                   for a, r, _ in outs),
               "device_ms_by_kernel": by_kernel}
        out.append(rec)
        print(f"[check] {json.dumps(rec)}", flush=True)
    for rec in out:
        # conv gradients: sums of up to 147,456 products, held to their
        # scale; the conv forward (sums of up to 3456 O(1) products),
        # dense and attention: f32 rounding of O(1) outputs; the LSTM
        # kernels: sums of up to n products carried through T steps, each
        # output within 1e-4 of its largest entry (as chip_smoke.py)
        if rec["kernel"].startswith("lstm"):
            bad = rec["rel_err"] > 1e-4
        elif rec["kernel"] == "conv_block":
            bad = not rec["close"]
        else:
            bad = rec["max_abs_err"] > (
                5e-5 * rec["scale"] if rec["kernel"].startswith("conv")
                else 1e-4)
        if bad or not rec["bitwise_repeat"] or rec["launches"] != 2:
            raise RuntimeError(f"{rec['shape_of']}: {rec}")
    return 0


def groups(torch):
    from chip_smoke import card_line, graph_ms
    from deeplearning4j_tpu_torch.ops import _build, conv_bwd_data_reference
    from deeplearning4j_tpu_torch.ops.conv_block import (
        RESIDENT_MAX_THREADS,
        resident_smem_bytes,
    )

    torch.backends.cudnn.allow_tf32 = False
    lib = _build.load()
    (n, c, h, w), (o, _, kh, kw) = next(
        shape for name, kind, shape in SHAPES
        if (name, kind) == ("lenet256.conv2", "conv_bwd_data"))
    oh, ow = h - kh + 1, w - kw + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    wt = torch.randn((o, c, kh, kw), device="cuda", generator=gen) / 500 ** 0.5
    dacc = torch.randn((n, o, oh, ow), device="cuda", generator=gen)
    ref = conv_bwd_data_reference(dacc, wt, (h, w))
    dx = torch.empty((n, c, h, w), device="cuda")
    scratch = torch.empty(3 * kh * kw * o * 8, device="cuda")
    out = {}
    for g, tg in ((20, 1), (20, 2), (20, 3), (10, 1), (10, 5), (4, 1),
                  (4, 8), (4, 16)) * 2:
        per = -(-g // 4) * oh * ow
        assert tg * per <= RESIDENT_MAX_THREADS

        def launch(g=g, tg=tg):
            _build.check(lib.dl4j_conv_bwd_data_resident(
                dacc.data_ptr(), wt.data_ptr(), scratch.data_ptr(),
                dx.data_ptr(), n, c, h, w, o, kh, kw, 1, 1, 0, 0, oh, ow, g,
                tg, torch.cuda.current_stream().cuda_stream),
                "conv_bwd_data")
        launch()
        torch.cuda.synchronize()
        err = float((dx - ref).abs().max())
        rec = out.setdefault(f"group {g}, tap groups {tg}", {
            "smem_bytes": resident_smem_bytes(h, w, o, oh, ow, kh, kw, g, tg),
            "threads": tg * per, "max_abs_err": err, "ms": []})
        rec["ms"].append(graph_ms(torch, launch))
    print(json.dumps({"card": card_line(), "lenet256.conv2": out}))
    return 0


def rows(torch):
    """The cluster route's rows a cluster at the char-RNN's chunk."""
    import ctypes

    from chip_smoke import card_line, events_ms
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops.lstm_cell import LSTM_CLUSTER

    T, b, n = 50, 32, 200
    lib = _build.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")

    def randn(*dims):
        return torch.randn(dims, device=dev, generator=gen) * 0.1

    xproj, rw = randn(T, b, 4 * n), randn(n, 4 * n)
    h0, c0, dhT, dcT = (randn(b, n) for _ in range(4))
    hprev, cprev, cseq, dhseq, hseq = (randn(T, b, n) for _ in range(5))
    dgates = torch.empty_like(xproj)
    hT, cT = torch.empty_like(h0), torch.empty_like(h0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for r in (1, 2, 4, 8):
        def fwd(r=r):
            _build.check(lib.dl4j_lstm_seq_fwd(
                xproj.data_ptr(), rw.data_ptr(), h0.data_ptr(),
                c0.data_ptr(), hseq.data_ptr(), cseq.data_ptr(),
                hT.data_ptr(), cT.data_ptr(), None, T, b, n, LSTM_CLUSTER,
                r, stream), "lstm_seq_fwd")

        def bwd(r=r):
            _build.check(lib.dl4j_lstm_seq_bwd(
                xproj.data_ptr(), hprev.data_ptr(), cprev.data_ptr(),
                cseq.data_ptr(), rw.data_ptr(), dhseq.data_ptr(),
                dhT.data_ptr(), dcT.data_ptr(), dgates.data_ptr(),
                hT.data_ptr(), cT.data_ptr(), None, T, b, n, LSTM_CLUSTER,
                r, stream), "lstm_seq_bwd")
        rec = {"clusters": -(-b // r)}
        for name, fn, is_bwd in (("fwd", fwd, 0), ("bwd", bwd, 1)):
            smem, active = ctypes.c_int(0), ctypes.c_int(0)
            _build.check(lib.dl4j_lstm_cluster_plan(
                is_bwd, b, n, LSTM_CLUSTER, r, ctypes.byref(smem),
                ctypes.byref(active)), "lstm_seq_plan")
            rec[f"{name}_ms"] = [events_ms(torch, fn)[0] for _ in range(2)]
            rec[f"{name}_max_active_clusters"] = active.value
            rec[f"{name}_smem_bytes"] = smem.value
        out[f"rows {r}"] = rec
    print(json.dumps({"card": card_line(), "T": T, "b": b, "n": n,
                      "cluster": LSTM_CLUSTER, "rows": out}))
    return 0


def _sweep_plans(cb, lc, kind, shape, ref, dtype):
    """(the rule's plan, {label: plan}) of every route ``kind`` has at
    ``shape``: the conv forward's direct route and each wide tile whose
    ring fits; ``conv_bwd_data``'s gemm route and the resident route at
    channel groups of up to 32, 16, 8 and 4 (each with as many tap groups
    as fit); ``conv_bwd_w``'s gemm and image-resident routes; the cell's
    slice route and latency plans of several rows and units a block."""
    if kind == "lstm_cell":
        b, n_ = shape[0], shape[1]
        plans = {"slice": lc.CellRoute("slice")}
        for rows in sorted({min(r, b) for r in (32, 16, 8, 4, 1)}):
            for units in (1, 2, 4):
                plan = lc.latency_plan(b, n_, rows, units)
                if plan.smem_bytes <= lc.CELL_SMEM_BYTES:
                    plans[f"latency r{rows} u{units}"] = plan
        return lc.lstm_cell_route(b, n_), plans
    if kind == "conv_block":
        (n, c, h, w), (o, _, kh, kw), st, pad = shape
        k_pad = -(-c * kh * kw // cb.WIDE_K_SLICE) * cb.WIDE_K_SLICE
        plans = {"direct": cb.ConvRoute("direct")}
        for tile in cb.WIDE_TILES:
            plan = cb.wide_plan(tile, n * ref.shape[2] * ref.shape[3], o,
                                k_pad)
            if plan.smem_bytes <= cb.BLOCK_SMEM_BYTES:
                plans[f"wide {tile[0]}x{tile[1]}"] = plan
        return cb.conv_block_route(n, c, h, w, o, kh, kw, st, pad,
                                   dtype), plans
    (n, c, h, w), (o, _, kh, kw), st, pad = _bwd_shape(shape)
    oh = (h + 2 * pad[0] - kh) // st[0] + 1
    ow = (w + 2 * pad[1] - kw) // st[1] + 1
    if kind == "conv_bwd_w":
        rule = cb.conv_bwd_w_route(n, c, h, w, o, kh, kw, st, pad)
        plans = {"gemm": cb.BwdWRoute("gemm")}
        # the image-resident plan also where the rule's cap on the images
        # a block walks turns it down
        cap = cb.BWD_W_MAX_IMAGES
        cb.BWD_W_MAX_IMAGES = n
        try:
            plan = cb.conv_bwd_w_route(n, c, h, w, o, kh, kw, st, pad)
        finally:
            cb.BWD_W_MAX_IMAGES = cap
        if plan.route != "gemm":
            plans["image_resident"] = plan
        return rule, plans
    rule = cb.conv_bwd_data_route(n, c, h, w, o, kh, kw, st, pad)
    plans = {"gemm": cb.BwdDataRoute("gemm")}
    for most in (32, 16, 8, 4):
        group = -(-c // -(-c // most))  # c in equal groups of <= most
        if cb.resident_smem_bytes(h, w, o, oh, ow, kh, kw,
                                  group) <= cb.RESIDENT_SMEM_BYTES:
            plans.setdefault(f"resident g{group}", cb._resident_plan(
                h, w, o, oh, ow, kh, kw, group))
    return rule, plans


def sweep(torch, only=None, dtype=None, kind_only=None):
    """Every route (and wide tile or plan) of the conv forward, both
    conv backward kernels and the cell at each of their shapes (LeNet-5's,
    AlexNet's, the char-RNN's, VGG-16's and ResNet-50's; ``only``: the
    shapes whose name starts so), forced through the wrappers (the route functions
    patched), in turns, each held to its plain version, with the library
    call and the bound beside; the data the route rules are fitted
    to. ``kind_only``: one kernel's shapes alone."""
    import importlib

    from chip_smoke import bound, card_line, conv_out, graph_ms, useful_macs

    cb = importlib.import_module("deeplearning4j_tpu_torch.ops.conv_block")
    lc = importlib.import_module("deeplearning4j_tpu_torch.ops.lstm_cell")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    route_fn = {"conv_block": (cb, "conv_block_route"),
                "conv_bwd_data": (cb, "conv_bwd_data_route"),
                "conv_bwd_w": (cb, "conv_bwd_w_route"),
                "lstm_cell": (lc, "lstm_cell_route")}
    half = dtype is not None and dtype != torch.float32
    for name, kind, shape in tuple(SHAPES) + tuple(model_sweep_shapes()):
        if (kind not in route_fn or (only and not name.startswith(only))
                or (kind_only and kind != kind_only)):
            continue
        if half and kind not in ("conv_block", "conv_bwd_w"):
            continue  # dx and the LSTM cell take f32 in every dtype
        kernel, plain, library = _operands(torch, kind, shape, gen, dtype)
        with torch.inference_mode():
            ref = plain()
        rule, plans = _sweep_plans(cb, lc, kind, shape, ref,
                                   dtype or torch.float32)
        rec = {"rule": rule._asdict()}
        if kind != "lstm_cell":
            (n, c, h, w), (o, _, kh, kw), st, pad = _bwd_shape(shape)
            geo = {"x": (n, c, h, w), "w": (o, c, kh, kw), "stride": st,
                   "padding": pad}
            out_elems = n * o * conv_out(h, kh, st[0], pad[0]) * conv_out(
                w, kw, st[1], pad[1])
            # the forward counts every tap (as chip_smoke.check_kernel), the
            # backward the taps that touch the input (check_bwd_kernel)
            flops = (2.0 * out_elems * c * kh * kw if kind == "conv_block"
                     else 2.0 * useful_macs(geo))
            x_bytes = 2.0 if half else 4.0
            nbytes = (x_bytes * n * c * h * w
                      + (x_bytes if kind == "conv_block" else 4.0)
                      * (o * c * kh * kw)
                      + (x_bytes if kind == "conv_block" else 4.0) * out_elems
                      + 4.0 * (o if kind == "conv_block" else 0))
            with torch.inference_mode():
                rec["library_ms"] = graph_ms(torch, library)
            rec["bound_ms"] = bound(flops, nbytes)[0]
        module, attr = route_fn[kind]
        chosen = getattr(module, attr)
        for turn in range(2):
            for label, plan in (list(plans.items()) if turn == 0
                                else list(plans.items())[::-1]):
                setattr(module, attr, lambda *a, p=plan, **k: p)
                try:
                    with torch.inference_mode():
                        got = kernel()
                        torch.cuda.synchronize()
                        pairs = (zip(got, ref) if kind == "lstm_cell"
                                 else [(got, ref)])
                        err = max(float((a.float() - r.float()).abs().max())
                                  for a, r in pairs)
                        ms = graph_ms(torch, kernel)
                finally:
                    setattr(module, attr, chosen)
                r = rec.setdefault(label, {"max_abs_err": err, "ms": []})
                r["ms"].append(ms)
        out[f"{kind}@{name}"] = rec
        print(f"[sweep] {kind}@{name} {json.dumps(rec)}", flush=True)
    print(json.dumps({"card": card_line(), "dtype": str(dtype or "f32"),
                      "sweep": out}))
    return 0


def worker(torch):
    from chip_smoke import device_ms, events_ms, graph_ms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    for name, kind, shape in SHAPES:
        kernel, _, library = _operands(torch, kind, shape, gen)
        if kind == "lstm_cell":  # no library call computes the cell
            with torch.inference_mode():
                times[f"{kind}@{name}"] = {
                    "ms": graph_ms(torch, kernel),
                    "host_ms": events_ms(torch, kernel)[1]}
            continue
        if kind.startswith("lstm"):
            with torch.inference_mode():
                ms = device_ms(torch, kernel)
                host_ms = events_ms(torch, kernel)[1]
            # the library backward needs its retained graph: no
            # inference mode
            times[f"{kind}@{name}"] = {
                "ms": ms, "library_ms": device_ms(torch, library),
                "host_ms": host_ms}
            continue
        with torch.inference_mode():
            times[f"{kind}@{name}"] = {
                "ms": graph_ms(torch, kernel),
                "library_ms": graph_ms(torch, library)}
    print(json.dumps(times))
    return 0


def compare(parent: str, rounds: int) -> int:
    from chip_smoke import card_line

    trees = {"parent": os.path.abspath(parent), "this": HERE}
    runs = {"parent": [], "this": []}
    for _ in range(rounds):
        for tag in ("parent", "this", "this", "parent"):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 trees[tag]], capture_output=True, text=True, timeout=900,
                cwd=trees[tag])
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                return proc.returncode
            times = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[tag].append(times)
            print(json.dumps({"tree": tag, **times}))
    medians = {tag: {name: {key: statistics.median(r[name][key]
                                                   for r in runs[tag])
                            for key in runs[tag][0][name]}
                     for name in runs[tag][0]}
               for tag in runs}
    print(json.dumps({"card": card_line(), "medians": medians,
                      "rounds": rounds}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--check-from", type=int, metavar="I")
    ap.add_argument("--groups", action="store_true")
    ap.add_argument("--rows", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--only", metavar="PREFIX",
                    help="--sweep: only the shapes whose name starts so")
    ap.add_argument("--kind", choices=("conv_block", "conv_bwd_data",
                                       "conv_bwd_w", "lstm_cell"),
                    help="--sweep: only this kernel's shapes")
    ap.add_argument("--dtype", choices=("float32", "bfloat16", "float16"),
                    help="--sweep: the conv forward's operands and the dW "
                         "image in this dtype")
    ap.add_argument("--parent")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", metavar="ROOT")
    args = ap.parse_args()
    # the tree whose package is imported: ROOT for a worker, else this one
    sys.path.insert(0, args.worker or HERE)
    import torch

    if not torch.cuda.is_available():
        print("torch_route_ab: no CUDA device is available", file=sys.stderr)
        return 2
    if args.worker:
        return worker(torch)
    if args.check:
        return check(torch)
    if args.check_from is not None:
        return check_from(torch, args.check_from)
    if args.groups:
        return groups(torch)
    if args.rows:
        return rows(torch)
    if args.sweep:
        return sweep(torch, args.only,
                     getattr(torch, args.dtype) if args.dtype else None,
                     args.kind)
    if not args.parent:
        ap.error("give --check, --groups, --rows, --sweep or --parent DIR")
    return compare(args.parent, args.rounds)


if __name__ == "__main__":
    sys.exit(main())
