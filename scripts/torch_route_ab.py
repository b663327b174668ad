#!/usr/bin/env python3
"""The routed and redesigned kernels of the port at their main-path
shapes on one CUDA card: ``conv_bwd_data`` at LeNet-5's conv2 (batch 256,
the resident route), ``conv_bwd_w`` at LeNet-5's conv1 and conv2 (batch
256, the image-resident route), the dense kernel at the transformer's
input projection and, with the residual, its FFN's second product (the
wide route), and flash attention's two entries at the transformer's
shapes (f32, causal: b·h 192 × t 512 for ``flash_attention``, b·h 12 × t
16384 for ``flash_attention_streamed``).

    python3 scripts/torch_route_ab.py --check
    python3 scripts/torch_route_ab.py --parent DIR [--rounds N]

``--check`` prints what ``nvcc -Xptxas -v`` reports for the kernel
sources (registers, shared memory, spills), then runs each kernel once
at each shape, holds it against its plain PyTorch version and a second
launch (bitwise), and prints one JSON line with the device time of
each CUDA kernel one call launches (``torch.profiler``).

``--groups`` times the resident ``conv_bwd_data`` kernel at LeNet-5's
conv2 with several channel-group sizes (20: one group of all the
channels; 10 and 4: two and five groups, smaller blocks) and tap-group
counts (more threads a block), in turns, the launch made directly, and
prints one JSON line.

``--parent DIR`` times the kernels of a second tree (an unpacked
``git archive`` of another commit, whose ``deeplearning4j_tpu_torch``
takes the same calls) against this one's, in turns (parent, this, this,
parent, ``--rounds`` times), one process a turn, with CUDA events around
CUDA-graph replays, and the PyTorch library call beside each
(``conv2d_input``, ``conv2d_weight``; ``addmm`` plus the residual add;
``scaled_dot_product_attention``). TF32 is off. Prints one JSON line per
turn and one with the medians and the card's name and power limit.
Exits non-zero without a card.
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
    ("lenet256.conv2", "conv_bwd_data", ((256, 20, 12, 12), (50, 20, 5, 5))),
    ("lenet256.conv1", "conv_bwd_w", ((256, 1, 28, 28), (20, 1, 5, 5))),
    ("lenet256.conv2", "conv_bwd_w", ((256, 20, 12, 12), (50, 20, 5, 5))),
    ("transformer.input", "matmul_block", (8192, 256, 768, False)),
    ("transformer.ffn2", "matmul_block_residual", (8192, 3072, 768, True)),
    ("transformer", "flash_attention", (16, 12, 512, 64)),
    ("long", "flash_attention_streamed", (1, 12, 16384, 64)),
)
SOURCES = ("matmul_block.cu", "conv_bwd.cu", "flash_attention.cu")


def _operands(torch, kind, shape, gen):
    """(kernel, plain, library) calls of ``kind`` at ``shape``."""
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
        xs, ws = shape
        oh, ow = xs[2] - ws[2] + 1, xs[3] - ws[3] + 1
        x = torch.randn(xs, device=dev, generator=gen)
        w = torch.randn(ws, device=dev, generator=gen) / (
            ws[1] * ws[2] * ws[3]) ** 0.5
        dacc = torch.randn((xs[0], ws[0], oh, ow), device=dev, generator=gen)
        if kind == "conv_bwd_w":
            return (lambda: conv_bwd_w(x, dacc, ws),
                    lambda: conv_bwd_w_reference(x, dacc, ws),
                    lambda: torch.nn.grad.conv2d_weight(x, ws, dacc))
        return (lambda: conv_bwd_data(dacc, w, xs[2:]),
                lambda: conv_bwd_data_reference(dacc, w, xs[2:]),
                lambda: torch.nn.grad.conv2d_input(xs, w, dacc))
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


def _route(kind, shape):
    from deeplearning4j_tpu_torch.ops.conv_block import (
        conv_bwd_data_route,
        conv_bwd_w_route,
    )
    from deeplearning4j_tpu_torch.ops.matmul_block import matmul_route

    if kind.startswith("flash"):
        return "single"
    if kind.startswith("conv"):
        (n, c, h, w), (o, _, kh, kw) = shape
        pick = conv_bwd_w_route if kind == "conv_bwd_w" else \
            conv_bwd_data_route
        return pick(n, c, h, w, o, kh, kw).route
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


def check(torch):
    from chip_smoke import profiled_device_ms
    from deeplearning4j_tpu_torch.ops import dispatch

    for line in _ptxas_report():
        print(line)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for name, kind, shape in SHAPES:
        kernel, plain, library = _operands(torch, kind, shape, gen)
        dispatch.reset_launch_counts()
        with torch.inference_mode():
            got, again, ref, lib = kernel(), kernel(), plain(), library()
        torch.cuda.synchronize()
        scale = max(float(ref.abs().max()), 1.0)
        launches = dispatch.launch_counts()[kind]
        with torch.inference_mode():
            _, by_kernel = profiled_device_ms(torch, kernel)
        rec = {"shape_of": name, "kernel": kind,
               "kernel_route": _route(kind, shape),
               "launches": launches,
               "bitwise_repeat": bool(torch.equal(got, again)),
               "max_abs_err": float((got - ref).abs().max()),
               "library_max_abs_err": float((got - lib).abs().max()),
               "scale": scale, "device_ms_by_kernel": by_kernel}
        out.append(rec)
        print(f"[check] {json.dumps(rec)}")
    for rec in out:
        # conv gradients: sums of up to 147,456 products, held to their
        # scale; dense and attention: f32 rounding of O(1) outputs
        tol = (5e-5 * rec["scale"] if rec["kernel"].startswith("conv")
               else 1e-4)
        if (rec["max_abs_err"] > tol or not rec["bitwise_repeat"]
                or rec["launches"] != 2):
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
    (n, c, h, w), (o, _, kh, kw) = SHAPES[0][2]
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


def worker(torch):
    from chip_smoke import graph_ms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    for name, kind, shape in SHAPES:
        kernel, _, library = _operands(torch, kind, shape, gen)
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
                            for key in ("ms", "library_ms")}
                     for name in runs[tag][0]}
               for tag in runs}
    print(json.dumps({"card": card_line(), "medians": medians,
                      "rounds": rounds}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--groups", action="store_true")
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
    if args.groups:
        return groups(torch)
    if not args.parent:
        ap.error("give --check or --parent DIR")
    return compare(args.parent, args.rounds)


if __name__ == "__main__":
    sys.exit(main())
