"""The kernels' plans (``deeplearning4j_tpu_torch/ops/tiling.py``), on
the CPU: at every kernel shape the phases of ``chip_smoke.py`` launch
(LeNet-5, AlexNet, VGG-16 at 32 x 32, ResNet-50, GoogLeNet, the conv ->
LSTM net, the transformer, the LSTMs) and at Keras's VGG-16 at 224 x
224, the heuristic plan is today's route function's and is among the
candidates; every candidate fits the H100's budgets; a shape a route
cannot take yields no plan of that route (JAX
``tests/test_autotune.py::TestTiling``'s cases, re-derived for Hopper).
The split counts are held to the C library's former rule on the card
(``tests/test_torch_cuda.py::test_python_split_rule_is_the_librarys``).
"""

import importlib

import pytest

import chip_smoke as cs
from deeplearning4j_tpu_torch.ops import tiling
from deeplearning4j_tpu_torch.zoo import alexnet, lenet

cb = importlib.import_module("deeplearning4j_tpu_torch.ops.conv_block")
lc = importlib.import_module("deeplearning4j_tpu_torch.ops.lstm_cell")
mb = importlib.import_module("deeplearning4j_tpu_torch.ops.matmul_block")


def _conv_table():
    rows = []
    for tag, shapes in (
            ("lenet", cs.kernel_shapes(lenet(), cs.LENET_BUCKET)),
            ("lenet256", cs.kernel_shapes(lenet(), cs.LENET_TRAIN_BATCH)),
            ("alexnet", cs.kernel_shapes(alexnet(), cs.ALEXNET_BATCH))):
        rows += [(f"{tag}.{n}", k, g) for n, k, g in cs.step_shapes(shapes)]
    for tag, shapes in (("vgg16", cs.vgg_shapes()),
                        ("resnet50", cs.resnet_shapes()),
                        ("alexnet-train", cs.alexnet_train_shapes()),
                        ("googlenet", cs.googlenet_shapes()),
                        ("conv-lstm", cs.conv_lstm_shapes()),
                        ("keras-vgg16", cs.keras_vgg16_shapes())):
        rows += [(f"{tag}.{n}", k, g) for n, k, g, _ in shapes]
    return rows


SHAPES = _conv_table()
CONV = [(name, kind, g) for name, kind, g in SHAPES if kind != "matmul_block"]
DENSE = sorted({(g["m"], g["k"], g["n"]) for _, kind, g in SHAPES
                if kind == "matmul_block"}
               | {(16 * 512, 768, 768), (16 * 512, 768, 3072),
                  (16 * 512, 3072, 768), (16 * 512, 768, 256),
                  (cs.MLP_BATCH, cs.W2V_DIM, cs.MLP_HIDDEN),
                  (cs.SEMB_BATCH // 2, cs.W2V_DIM, cs.MLP_HIDDEN),
                  # the conv listener's batch-1 dense layers (skinny)
                  (1, 9216, 4096), (1, 4096, 4096), (1, 800, 500),
                  (8, 1001, 770)})
CELLS = [(cs.CHAR_BATCH, cs.CHAR_HIDDEN), (1, cs.CHAR_HIDDEN),
         (cs.SATURATED[1], cs.SATURATED[2]), (8, 48), (300, 13)]
SEQS = [(cs.CHAR_TBPTT, cs.CHAR_BATCH, cs.CHAR_HIDDEN),
        (1, 1, cs.CHAR_HIDDEN), cs.SATURATED, (4, 3, 40), (2, 70, 13)]


def _args(g):
    n, c, h, w = g["x"]
    o, _, kh, kw = g["w"]
    return (n, c, h, w, o, kh, kw, tuple(g["stride"]), tuple(g["padding"]))


FAMILY = {"conv_block": "conv_block", "conv_bwd_data": "conv_bwd_data",
          "conv_bwd_w": "conv_bwd_w"}


def test_the_table_covers_every_phase_and_keras_vgg16():
    tags = {name.split(".")[0] for name, _, _ in SHAPES}
    assert {"lenet", "alexnet", "vgg16", "resnet50", "googlenet",
            "conv-lstm", "keras-vgg16"} <= tags
    keras = [s for s in SHAPES if s[0].startswith("keras-vgg16.")]
    assert len(keras) == 28
    assert any(g.get("x", (0, 0, 0))[2] == 224 for _, _, g in keras)
    assert (16, 25088, 4096) in DENSE


@pytest.mark.parametrize("name,kind,g", CONV, ids=[
    f"{n}-{k}" for n, k, _ in CONV])
def test_conv_heuristic_is_the_route_and_a_candidate(name, kind, g):
    args = _args(g)
    heuristic, candidates, _ = tiling.FAMILIES[FAMILY[kind]]
    plan = heuristic(*args)
    assert plan in candidates(*args), (name, plan)
    n, c, h, w, o, kh, kw, stride, padding = args
    oh = cb.conv_output_size(h, kh, stride[0], padding[0])
    ow = cb.conv_output_size(w, kw, stride[1], padding[1])
    if kind == "conv_block":
        route = cb.conv_block_route(*args)
        assert plan[0] == route.route
        if route.route == "wide":
            assert plan[1:] == (route.tile_o, route.tile_px)
        else:
            assert plan == ("direct", tiling.direct_splits(n, c, o, kh, kw,
                                                           oh, ow))
    elif kind == "conv_bwd_data":
        route = cb.conv_bwd_data_route(*args)
        assert plan[0] == route.route
        if route.route == "resident":
            assert plan[1:] == (route.group, route.tap_groups)
        else:
            assert plan == ("gemm", tiling.data_splits(n, c, h, w, o, kh, kw))
    else:
        route = cb.conv_bwd_w_route(*args)
        assert plan[0] == route.route
        if route.route == "image_resident":
            assert plan[1:] == (route.group, route.pixel_groups,
                                route.images_per_chunk)
        else:
            assert plan == ("gemm", tiling.weight_splits(n, c, o, kh, kw, oh,
                                                         ow))


def _fits_conv(kind, plan, args):
    n, c, h, w, o, kh, kw, stride, padding = args
    oh = cb.conv_output_size(h, kh, stride[0], padding[0])
    ow = cb.conv_output_size(w, kw, stride[1], padding[1])
    if plan[0] == "wide":
        k_pad = -(-c * kh * kw // cb.WIDE_K_SLICE) * cb.WIDE_K_SLICE
        assert plan[1:] in cb.WIDE_TILES
        assert cb.conv_wide_smem_bytes(*plan[1:], k_pad) \
            <= tiling.BLOCK_SMEM_BYTES
        assert c * h * w < 2 ** 31 and h + padding[0] < cb.WIDE_PAD_TAP
    elif plan[0] == "resident":
        group, taps = plan[1:]
        assert 1 <= group <= cb.RESIDENT_MAX_GROUP
        assert cb.resident_smem_bytes(h, w, o, oh, ow, kh, kw, group, taps) \
            <= tiling.BLOCK_SMEM_BYTES
        per = min(cb.RESIDENT_MAX_THREADS,
                  -(-(-(-group // 4) * oh * ow) // 32) * 32)
        assert 1 <= taps <= kh * kw and taps * per <= cb.RESIDENT_MAX_THREADS
    elif plan[0] == "image_resident":
        group, pixel_groups, per_chunk = plan[1:]
        items = -(-o // 4) * kw * group
        threads = -(-items * pixel_groups // 32) * 32
        assert kh == kw <= cb.BWD_W_MAX_K and oh % pixel_groups == 0
        assert threads <= cb.BWD_W_MAX_THREADS
        assert tiling.fits_registers(threads, tiling.BWD_W_REGISTERS, 2)
        assert cb.bwd_w_smem_bytes(h, w, o, oh, ow, kw, group, pixel_groups) \
            <= tiling.BLOCK_SMEM_BYTES
        assert 1 <= per_chunk <= n
    else:
        k_len = {"direct": c * kh * kw, "gemm": (o * kh * kw if kind ==
                                                 "conv_bwd_data"
                                                 else n * oh * ow)}[plan[0]]
        cap = tiling.MAX_DW_SPLITS if kind == "conv_bwd_w" \
            else tiling.MAX_SPLITS
        assert tiling.split_ok(k_len, plan[1], cap)


@pytest.mark.parametrize("name,kind,g", CONV, ids=[
    f"{n}-{k}" for n, k, _ in CONV])
def test_every_conv_candidate_fits_the_budgets(name, kind, g):
    args = _args(g)
    plans = tiling.FAMILIES[FAMILY[kind]][1](*args)
    assert plans and len(set(plans)) == len(plans)
    for plan in plans:
        _fits_conv(kind, plan, args)
        assert tiling.FAMILIES[FAMILY[kind]][2](plan, *args) > 0


@pytest.mark.parametrize("m,k,n", DENSE)
def test_dense_heuristic_candidates_and_budgets(m, k, n):
    plan = tiling.matmul_heuristic(m, k, n)
    assert plan[0] == mb.matmul_route(m, n)
    splits = {"wide": lambda *a: 1, "tiled": tiling.matmul_splits,
              "skinny": tiling.skinny_splits}[plan[0]]
    assert plan == (plan[0], splits(m, k, n))
    plans = tiling.matmul_candidates(m, k, n)
    assert plan in plans and ("wide", 1) in plans
    assert any(p[0] == "skinny" for p in plans) == (m <= mb.SKINNY_MAX_M)
    for p in plans:
        assert tiling.split_ok(k, p[1]) and (p[0] != "wide" or p[1] == 1)
        assert tiling.matmul_prior(p, m, k, n) > 0


@pytest.mark.parametrize("m,k,n,splits", [
    (1, 9216, 4096, 17), (1, 4096, 4096, 16), (1, 800, 500, 25),
    (1, 3072, 768, 32), (8, 9216, 4096, 17), (5, 40, 130, 1)])
def test_skinny_splits_are_the_measured_winners(m, k, n, splits):
    """The skinny route's split rule at the shapes it was fitted to
    (``scripts/torch_dense_m1_ab.py``): two waves of 256-column blocks,
    chunks at least 32 deep, at most MAX_SPLITS."""
    assert tiling.skinny_splits(m, k, n) == splits
    assert tiling.matmul_heuristic(m, k, n) == ("skinny", splits)


@pytest.mark.parametrize("b,n", CELLS)
def test_cell_heuristic_candidates_and_budgets(b, n):
    plan = tiling.lstm_cell_heuristic(b, n)
    route = lc.lstm_cell_route(b, n)
    assert plan == (("latency", route.rows, route.units, route.splits)
                    if route.route == "latency" else ("slice",))
    plans = tiling.lstm_cell_candidates(b, n)
    assert plan in plans and plans[-1] == ("slice",)
    for p in plans[:-1]:
        _, rows, units, splits = p
        assert lc.lstm_cell_smem_bytes(n, rows, units) \
            <= tiling.CELL_SMEM_BYTES
        assert rows * units * splits <= lc.CELL_MAX_THREADS
        assert splits & (splits - 1) == 0 and splits <= lc.CELL_MAX_SPLITS


@pytest.mark.parametrize("T,b,n", SEQS)
@pytest.mark.parametrize("bwd", [False, True])
def test_sequence_heuristic_candidates_and_budgets(T, b, n, bwd):
    plan = tiling.lstm_seq_heuristic(T, b, n, bwd)
    route = lc.lstm_seq_route(T, b, n, bwd)
    assert plan == (("cluster", route.cluster, route.rows)
                    if route.route == "cluster" else ("grid",))
    plans = tiling.lstm_seq_candidates(T, b, n, bwd)
    assert plan in plans and plans[-1] == ("grid",)
    for p in plans[:-1]:
        _, blocks, rows = p
        u = -(-n // blocks)
        assert u <= lc.LSTM_CLUSTER_MAX_UNITS and (blocks - 1) * u < n
        assert rows in lc.LSTM_CLUSTER_ROWS and rows * u <= lc.LSTM_THREADS
        assert lc.lstm_cluster_smem_bytes(n, blocks, rows, bwd) \
            <= tiling.LSTM_CLUSTER_SMEM_CAP


def test_infeasible_shapes_yield_no_plan_of_their_route():
    # no wide tile where the tap table's int32 offsets overflow
    big = (1, 2048, 1024, 1024, 64, 3, 3, (1, 1), (1, 1))
    assert all(p[0] == "direct" for p in tiling.conv_fwd_candidates(*big))
    # no resident dx group at 224 x 224 x 64 (a dx tile alone is 196 KB)
    vgg = (16, 64, 224, 224, 64, 3, 3, (1, 1), (1, 1))
    assert all(p[0] == "gemm" for p in tiling.conv_bwd_data_candidates(*vgg))
    # no image-resident dW past 5 x 5 kernels
    stem = (8, 3, 224, 224, 64, 7, 7, (2, 2), (3, 3))
    assert all(p[0] == "gemm" for p in tiling.conv_bwd_w_candidates(*stem))
    # no latency cell past 48 KB, no cluster past n 256
    assert tiling.lstm_cell_candidates(256, 4096) == [("slice",)]
    assert tiling.lstm_seq_candidates(4, 8, 300, True) == [("grid",)]
    # the flash kernel: one tile, and none outside its head dimensions
    assert tiling.attention_candidates(512, 64) == [(128, 64)]
    with pytest.raises(ValueError, match="head dimension"):
        tiling.attention_candidates(512, 256)


def test_split_rule_and_its_range():
    # no split past two waves, or under two 64-deep chunks
    assert tiling.plan_splits(tiling.TARGET_BLOCKS, 10_000) == 1
    assert tiling.plan_splits(1, 127) == 1
    # LeNet's conv2 at bucket 32: 25 tiles over k 500 -> 7 chunks of 80
    assert tiling.plan_splits(25, 500) == 7
    assert tiling.k_chunk_for(500, 7) == 80
    # fc1 of VGG-16 at batch 16: 64 tiles over k 25,088 -> 5
    assert tiling.matmul_splits(16, 25088, 4096) == 5
    # the dW rule: LeNet's conv1 at batch 256 (one tile, 147,456 deep)
    assert tiling.weight_splits(256, 1, 20, 5, 5, 24, 24) == \
        tiling.plan_dw_splits(1, 256 * 24 * 24) == 264
    for k_len in (16, 100, 500, 25088):
        for s in range(1, 40):
            ok = tiling.split_ok(k_len, s)
            assert ok == (s == 1 or (s <= tiling.MAX_SPLITS
                                     and tiling.chunks_of(k_len, s) == s))
    with pytest.raises(ValueError, match="outside the kernel's range"):
        tiling.check_splits("matmul_block", 100, 33)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        tiling.check_splits("matmul_block", 16, 3)  # an empty chunk
    tiling.check_splits("conv_bwd_w", 147_456, 264, tiling.MAX_DW_SPLITS)


def test_budgets_are_the_h100s_and_the_modules_read_them():
    assert (tiling.SM_COUNT, tiling.BLOCK_SMEM_BYTES, tiling.SM_SMEM_BYTES,
            tiling.SM_REGISTERS, tiling.THREAD_MAX_REGISTERS) == (
        132, 232_448, 233_472, 65_536, 255)
    assert tiling.BWD_W_REGISTERS * 2 * cb.BWD_W_MAX_THREADS \
        <= tiling.SM_REGISTERS
    fa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")
    assert (cb.BLOCK_SMEM_BYTES, cb.SM_COUNT, cb.BWD_W_REGISTERS,
            lc.CELL_SMEM_BYTES, lc.MAX_SMEM_BYTES, fa.FLASH_SMEM_BYTES) == (
        tiling.BLOCK_SMEM_BYTES, tiling.SM_COUNT, tiling.BWD_W_REGISTERS,
        tiling.CELL_SMEM_BYTES, tiling.BLOCK_SMEM_BYTES,
        tiling.FLASH_SMEM_BYTES)


def test_plan_tags():
    assert tiling.plan_tag(("wide", 96, 256)) == "wide:96x256"
    assert tiling.plan_tag(("slice",)) == "slice"
