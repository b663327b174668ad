"""Pieces of ``chip_smoke.py`` that run without a card: the kernel
line's launch sums, the ``[loop]`` phase's regression bomb (LeNet-5 at
full width, a few Adam steps on synthetic MNIST), and rehearsals of the
``[semb-dp]`` and ``[nlp-periphery]`` phases at small sizes, on the
CPU."""

import json
import warnings

import numpy as np
import pytest
import torch

import chip_smoke as cs
from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo import lenet


def test_path_launches_sums_the_named_main_paths():
    """The transformer kernels' launches come from ``[default-fit]`` by
    name, wherever it stands among the runtime phases (the phases after
    it launch none of them)."""
    paths = {"default-fit": {"flash_attention": 204, "conv_block": 7},
             "fleet": {"conv_block": 3},
             "aot-restart": {"conv_block": 2},
             "loop": {"conv_block": 11, "matmul_block": 5}}
    assert cs.path_launches("flash_attention", paths, ["default-fit"]) == 204
    assert cs.path_launches("conv_block", paths) == 23
    assert cs.path_launches("matmul_block", paths) == 5
    assert cs.path_launches("lstm_cell", paths) == 0


def test_regression_bomb_is_dormant_on_the_pool_and_fires_when_hot():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        batches = list(MnistDataSetIterator(
            cs.LENET_TRAIN_BATCH, allow_synthetic=True,
            num_examples=cs.LENET_TRAIN_BATCH * 8))
    live = MultiLayerNetwork(lenet(), device="cpu").init()
    for ds in batches:
        live.fit_minibatch(ds)
    pool = cs.loop_pool()
    assert pool.shape == (cs.LOOP_POOL, 784) and not pool[:, 0].any()
    assert (cs.hot(pool)[:, 0] == cs.LOOP_HOT).all()
    before = {k: {n: t.clone() for n, t in v.items()}
              for k, v in live.params.items()}
    bomb, unit, agree = cs.regression_bomb(torch, live, pool)
    # the live model is untouched; the bomb answers the pool bitwise
    for k, v in before.items():
        for n, t in v.items():
            assert torch.equal(live.params[k][n], t)
    assert torch.equal(bomb.output(pool), live.output(pool))
    assert bomb.feed_forward(pool)[4][:, unit].eq(0).all()
    assert agree < cs.LOOP_MIN_AGREEMENT
    assert bomb.feed_forward(cs.hot(pool))[4][:, unit].gt(0).all()


def test_semb_dp_phase_rehearses_on_cpu_ranks(capsys):
    """``[semb-dp]`` at a small vocabulary on two gloo CPU ranks: each
    rank holds half the table, the world of one and the cross-width
    resume hold, and ClusterWord2Vec equals one process (no kernel runs
    on the CPU, so no launch is counted)."""
    launches = cs.run_semb_dp(torch, "cpu", device="cpu", vocab=4096,
                              w2v_sentences=200)
    assert not any(launches.values())
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[semb-dp] {"))
    res = json.loads(line[len("[semb-dp] "):line.rindex(" card=")])
    assert res["embedding_shard_bytes"] == [4096 // 2 * 128 * 4] * 2
    assert res["resume_width1_bitwise_own_checkpoint"]
    assert res["resume_vs_ranks_rel_l2"] <= cs.TWIN_REL
    assert res["twin_w_past_elements"]["elements"] >= 0
    assert res["cluster_word2vec_bitwise"]


def test_nlp_periphery_phase_rehearses_on_cpu(capsys):
    cache, ids = cs.w2v_corpus(200)
    sv = cs.make_w2v(cache, ids, device="cpu")
    sv.device_epoch_gen = True
    sv.fit()
    cs.run_nlp_periphery(torch, "cpu", sv, cache, ids, device="cpu",
                         rows=3000)
    out = capsys.readouterr().out
    assert "[nlp-periphery] {" in out and '"tfidf_equal_cpu": true' in out


def test_network_phases_are_registered_and_summed_by_path():
    """The slice's five main paths run in NETWORK_PATHS's order, each a
    phase function; a kernel's launches on them are summed into its
    ``launches`` and listed by path name (``launches_by_path``), paths
    that did not launch it left out."""
    phases = cs.network_phases([], None, None)
    assert [t for t, _, _ in phases] == list(cs.NETWORK_PATHS) == [
        "googlenet", "moe-transformer", "moe-ep", "graph-charrnn",
        "conv-lstm"]
    assert all(callable(fn) for _, fn, _ in phases)
    paths = {"googlenet": {"conv_block": 741, "conv_bwd_w": 342},
             "moe-transformer": {"flash_attention": 360, "matmul_block": 63},
             "moe-ep": {"conv_block": 0},
             "graph-charrnn": {"lstm_cell": 2000, "lstm_seq_fwd": 416},
             "conv-lstm": {"conv_block": 66, "lstm_cell": 272}}
    assert cs.path_launches("conv_block", paths) == 807
    assert cs.network_launches("conv_block", paths) == {
        "googlenet": 741, "conv-lstm": 66}
    assert cs.network_launches("lstm_cell", paths) == {
        "graph-charrnn": 2000, "conv-lstm": 272}
    assert cs.network_launches("matmul_block_residual", paths) == {}


def test_network_phase_shapes_and_configurations():
    """GoogLeNet's 146 distinct step shapes and the conv -> LSTM net's 5
    are among the [kernel] records main() builds; the conv -> LSTM net
    infers its CNN <-> RNN adapters; the MoE LM is bench.py:866's LM
    with 4 experts."""
    assert len(cs.googlenet_shapes()) == 146
    assert [(n, k) for n, k, _, _ in cs.conv_lstm_shapes()] == [
        ("conv1", "conv_block"), ("conv1", "conv_bwd_w"),
        ("conv2", "conv_block"), ("conv2", "conv_bwd_data"),
        ("conv2", "conv_bwd_w")]
    conf = cs.conv_lstm_conf()
    assert [type(p).__name__ for _, p in sorted(conf.preprocessors.items())
            ] == ["RnnToCnnPreProcessor", "CnnToRnnPreProcessor",
                  "RnnToFeedForwardPreProcessor"]
    assert conf.layers[4].n_in == 800
    moe = cs.moe_conf()
    assert moe.layers[2].n_experts == cs.MOE_EXPERTS == 4
    assert moe.layers[2].ffn_hidden == 3072
    ds = cs.conv_lstm_batches(1, 2, seed=3)[0]
    assert ds.features.shape == (2, 784, cs.CONV_LSTM_T)
    assert ds.labels.shape == (2 * cs.CONV_LSTM_T, 10)


def test_phase_selector_and_the_selected_kernels_line():
    """``--phases`` names the phases of a run (none: every phase); the
    one kernels line of any run lists the kernels its phases launched,
    summed and by path, with the main path's times where the run made
    their records (null where not) and the per-step keys of the records
    it made."""
    assert cs.parse_phases([]) is None
    assert cs.parse_phases(["--phases", "gpipe, cluster"]) == {"gpipe",
                                                                "cluster"}
    paths = {"gpipe": {"matmul_block": 30, "conv_block": 0},
             "cluster": {"conv_block": 320, "matmul_block": 92},
             "transformer": cs.summed_launches(
                 (None, {"flash_attention": 240},
                  [{"flash_attention": 1}]))}
    assert paths["transformer"] == {"flash_attention": 241}
    rec = {"kernel": "matmul_block", "shape_of": "gpipe.stage",
           "kernel_route": "tiled", "launches_per_step": 2,
           "max_abs_err": 1e-6, "kernel_ms": 0.5, "plain_ms": 0.25,
           "bound_ms": 0.125, "bound_by": "operations", "library_ms": 0.375}
    line = {k["name"]: k for k in cs.kernels_line([rec], [], [], paths, {})}
    assert set(line) == {"matmul_block", "conv_block", "flash_attention"}
    mm = line["matmul_block"]
    assert mm["launches"] == 122
    assert mm["launches_by_path"] == {"gpipe": 30, "cluster": 92}
    assert mm["ms"] is None and mm["bound_by"] is None
    assert (mm["gpipe_kernel_ms_per_step"], mm["gpipe_bound_ms_per_step"],
            mm["gpipe_library_ms_per_step"]) == (1.0, 0.25, 0.75)
    assert line["conv_block"]["ms"] is None
    assert line["flash_attention"]["replaces"].endswith(
        "flash_attention.py:32")
    # a record of the main path's shape gives the contract's times
    main = dict(rec, shape_of="lenet.dense", launches_per_step=1,
                kernel_ms=0.125)
    mm = {k["name"]: k for k in cs.kernels_line(
        [rec, main], [], [], paths, {})}["matmul_block"]
    assert (mm["ms"], mm["bound_ms"], mm["bound_by"],
            mm["kernel_route"]) == (0.125, 0.125, "operations", "tiled")
    assert cs.network_launches("conv_block", {
        "cluster": {"conv_block": 320}, "fleet": {"conv_block": 3}},
        cs.NEW_PATHS) == {"cluster": 320}


def test_tensor_parallel_shapes_are_alexnets_halves():
    """[alexnet-tp]'s [kernel] shapes: each conv at half its
    out-channels, each dense layer at half its columns, the softmax
    head's product at 500 columns with the identity epilogue."""
    shapes = cs.alexnet_tp_shapes()
    convs = [g["w"][0] for n, k, g, _ in shapes if k == "conv_block"]
    assert convs == [48, 128, 192, 192, 128]
    dense = [(g["k"], g["n"], g["activation"]) for n, k, g, _ in shapes
             if k == "matmul_block"]
    assert dense == [(9216, 2048, "relu"), (4096, 2048, "relu"),
                     (4096, 500, "identity")]
    assert sum(k == "conv_bwd_data" for _, k, _, _ in shapes) == 4


def test_cluster_phase_rehearses_on_cpu(capsys):
    """``[cluster]`` on the plain path: the master's 4 rounds against one
    machine, the sharded evaluate, early stopping for 3 epochs."""
    launches = cs.run_cluster(torch, "cpu", device="cpu")
    assert not any(launches.values())
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[cluster] {"))
    res = json.loads(line[len("[cluster] "):line.rindex(" card=")])
    assert res["max_share_of_move"] <= cs.CLUSTER_SHARE
    assert res["early_stopping"]["epochs"] == cs.CLUSTER_ES_EPOCHS


def _phase_result(out: str, tag: str) -> dict:
    line = next(ln for ln in out.splitlines() if ln.startswith(f"[{tag}] {{"))
    return json.loads(line[len(f"[{tag}] "):line.rindex(" card=")])


def test_fit_phases_are_registered_and_on_the_kernels_line():
    """``[deep-ae]``, ``[vae]`` and ``[lenet-lbfgs]`` run in FIT_PATHS's
    order and answer ``--phases``; the LeNet solver path's launches are
    summed into the kernels line and listed by path; a solver call's
    launches follow its line-search trials."""
    assert [t for t, _ in cs.fit_phases()] == list(cs.FIT_PATHS) == [
        "deep-ae", "vae", "lenet-lbfgs"]
    assert cs.parse_phases(["--phases", "deep-ae,vae,lenet-lbfgs"]) == set(
        cs.FIT_PATHS)
    # LBFGS: two gradients a step, a forward a trial; CG's first call
    # one gradient more
    assert cs.solver_step_launches("LBFGS", [0, 2], False) == {
        "conv_block": 2 * 2 * 4 + 4 * 2, "conv_bwd_data": 4,
        "conv_bwd_w": 8, "matmul_block": 4 + 4}
    assert cs.solver_step_launches("CONJUGATE_GRADIENT", [1], True) == {
        "conv_block": 2 * 4 + 2 * 2, "conv_bwd_data": 2, "conv_bwd_w": 4,
        "matmul_block": 2 + 2}
    paths = {"deep-ae": {"conv_block": 0}, "vae": {},
             "lenet-lbfgs": {"conv_block": 90, "conv_bwd_data": 11,
                             "conv_bwd_w": 22, "matmul_block": 45},
             "train": {"conv_block": 200}}
    line = {k["name"]: k for k in cs.kernels_line([], [], [], paths, {})}
    assert set(line) == {"conv_block", "conv_bwd_data", "conv_bwd_w",
                         "matmul_block"}
    assert line["conv_block"]["launches"] == 290
    assert line["conv_block"]["launches_by_path"] == {"lenet-lbfgs": 90}
    assert line["matmul_block"]["launches_by_path"] == {"lenet-lbfgs": 45}


def test_fit_phase_configurations_are_the_examples():
    """The DeepAutoEncoder and the MNIST VAE at their published widths:
    the JAX package's parameter counts."""
    deep = cs.deep_ae_conf()
    assert [(layer.n_in, layer.n_out) for layer in deep.layers] == [
        (784, 1000), (1000, 500), (500, 250), (250, 100), (100, 30),
        (30, 100), (100, 250), (250, 500), (500, 1000), (1000, 784)]
    assert (deep.optimization_algo, deep.pretrain, deep.backprop,
            deep.iterations) == ("LINE_GRADIENT_DESCENT", True, True, 1)
    assert MultiLayerNetwork(deep, device="cpu").init().num_params() == \
        2_882_028
    vae = cs.vae_conf()
    layer = vae.layers[0]
    assert (layer.updater, layer.learning_rate, layer.l2, layer.activation,
            vae.pretrain, vae.backprop) == ("RMSPROP", 1e-3, 1e-4,
                                            "leakyrelu", True, False)
    assert MultiLayerNetwork(vae, device="cpu").init().num_params() == \
        535_828


@pytest.mark.parametrize("tag,kw", [
    ("deep-ae", {"widths": (784, 64, 32, 8), "batch": 64, "n_batches": 3}),
    ("vae", {"hidden": (32, 32), "batch": 32, "steps": 6}),
    ("lenet-lbfgs", {"batch": 32, "minibatches": 3, "dense_width": 64}),
])
def test_fit_phases_rehearse_on_cpu(capsys, tag, kw):
    """Each phase on the plain path at small widths: the twin holds (on
    the CPU bitwise), the score falls, no kernel launches."""
    fn = dict(cs.fit_phases())[tag]
    launches = fn(torch, "cpu", device="cpu", **kw)
    assert not any(launches.values())
    res = _phase_result(capsys.readouterr().out, tag)
    if tag == "deep-ae":
        assert res["score_after"] < res["score_pretrained"]
        assert res["twin_pretrain_max_abs_diff"] == 0.0
        assert res["twin_chain_flips"] == [0] * res["rbms"]
    elif tag == "vae":
        assert res["neg_elbo_after"] < res["neg_elbo_before"]
        assert res["twin_step1_grad_share"] == 0.0
    else:
        for algo in ("LBFGS", "CONJUGATE_GRADIENT"):
            assert res[algo]["score_after"] < res[algo]["score_before"]
            assert len(res[algo]["line_search_trials"]) == 3


def test_tune_phases_are_registered_and_on_the_kernels_line():
    assert [t for t, _, _ in cs.tune_phases()] == list(cs.TUNE_PATHS) == [
        "keras-vgg16", "autotune"]
    assert "keras-vgg16" in cs.PER_STEP_MODELS
    paths = {"keras-vgg16": {"conv_block": 65, "matmul_block": 6}}
    kernels = cs.kernels_line([], [], [], paths, {})
    conv = next(k for k in kernels if k["name"] == "conv_block")
    assert conv["launches_by_path"] == {"keras-vgg16": 65}


def test_keras_vgg16_configuration_is_keras_applications_vgg16():
    from deeplearning4j_tpu_torch.modelimport import (
        import_sequential_model_config,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer,
        DenseLayer,
        OutputLayer,
        SubsamplingLayer,
    )

    raw = json.loads(cs.keras_vgg16_config())
    assert raw["class_name"] == "Sequential"
    assert raw["config"][0]["config"]["batch_input_shape"] == [
        None, 3, 224, 224]
    assert {e["config"].get("dim_ordering") for e in raw["config"]
            if "dim_ordering" in e["config"]} == {"th"}
    conf = import_sequential_model_config(cs.keras_vgg16_config())
    convs = [l for l in conf.layers if isinstance(l, ConvolutionLayer)]
    assert len(convs) == 13 and all(
        tuple(l.padding) == (1, 1) for l in convs)
    assert sum(isinstance(l, SubsamplingLayer) for l in conf.layers) == 5
    dense = [l for l in conf.layers if isinstance(l, DenseLayer)]
    assert [(l.n_in, l.n_out) for l in dense] == [(25088, 4096),
                                                  (4096, 4096), (4096, 1000)]
    assert isinstance(conf.layers[-1], OutputLayer)
    assert conf.layers[-1].activation == "softmax"
    params = sum(l.n_out * l.n_in * 9 + l.n_out for l in convs) + sum(
        l.n_in * l.n_out + l.n_out for l in dense)
    assert params == cs.KERAS_VGG_PARAMS == 138_357_544
    shapes = cs.keras_vgg16_shapes()
    assert len(shapes) == 28
    assert sum(len(s[3]) for s in shapes if s[1] == "conv_bwd_data") == 12


def test_keras_vgg16_phase_rehearses_on_cpu(capsys):
    cfg = cs.keras_vgg16_config(image=32, widths=(4, 8, 8, 16, 16), fc=32,
                                classes=10)
    weights = cs.keras_vgg16_weights(cfg)
    assert weights["block1_conv1"]["W"].shape == (4, 3, 3, 3)
    assert weights["fc1"]["W"].shape == (16, 32)
    cs.run_keras_vgg16(torch, "cpu", device="cpu", config=cfg, batch=4,
                       steps=2)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[keras-vgg16] {")]
    res = json.loads(lines[0][len("[keras-vgg16] "):].rsplit(" card=", 1)[0])
    assert res["learning_rate"] == cs.KERAS_VGG_LR
    assert res["scores"][1] < res["scores"][0]
    assert res["launches_per_step"] == {"conv_block": 26,
                                        "conv_bwd_data": 12,
                                        "conv_bwd_w": 13, "matmul_block": 2}


def _tune_reports():
    ident = {"n": 16, "c": 3, "h": 224, "w": 224, "o": 64}
    on = {"searches": 1, "wall_s": 1.0, "shapes": [
        {"kernel": "conv_block", "identity": ident, "plan": "wide:96x256",
         "persisted": True, "heuristic": "wide:32x256", "heuristic_ms": 2.0,
         "winner_ms": 1.5, "measured": {}}]}
    cached = {"searches": 0, "measurements": 0, "hits": 1, "fallbacks": 0,
              "wall_s": 1.0, "shapes": [dict(on["shapes"][0])],
              "stale": {"counted": 1, "resolved": "wide:32x256",
                        "heuristic": "wide:32x256"},
              "held_max_rel_err": {}, "held_calls": {}}
    return on, cached


def test_check_tuning_holds_what_autotune_promises():
    on, cached = _tune_reports()
    assert cs.check_tuning(on, cached, 1) == {"shapes": 1, "changed": 1}
    on["shapes"][0]["winner_ms"] = 2.5
    with pytest.raises(RuntimeError, match="slower than the heuristic"):
        cs.check_tuning(on, cached, 1)
    on, cached = _tune_reports()
    cached["measurements"] = 3
    with pytest.raises(RuntimeError, match="measured 3"):
        cs.check_tuning(on, cached, 1)
    on, cached = _tune_reports()
    cached["shapes"][0]["plan"] = "wide:32x256"
    with pytest.raises(RuntimeError, match="persisted winners"):
        cs.check_tuning(on, cached, 1)
    on, cached = _tune_reports()
    cached["stale"]["counted"] = 0
    with pytest.raises(RuntimeError, match="stale"):
        cs.check_tuning(on, cached, 1)
    on, cached = _tune_reports()
    with pytest.raises(RuntimeError, match="expected 2"):
        cs.check_tuning(on, cached, 2)


def test_periphery_phases_are_registered_and_on_the_kernels_line():
    """``[ui]``, ``[ui-chunk]``, ``[tsne]``, ``[stream]``, ``[cloud-data]``
    and ``[native]`` run in PERIPHERY_PATHS's order and answer
    ``--phases``; their launches are summed into the kernels line and
    listed by path; the conv listener's batch-1 records give the
    ``alexnet_b1_*`` keys."""
    assert [t for t, _ in cs.periphery_phases()] == list(
        cs.PERIPHERY_PATHS) == ["ui", "ui-chunk", "tsne", "stream",
                                "cloud-data", "native"]
    assert cs.parse_phases(
        ["--phases", "ui,ui-chunk,tsne,stream,cloud-data,native"]) == set(
        cs.PERIPHERY_PATHS)
    paths = {"ui": {"conv_block": 110, "conv_bwd_data": 40,
                    "conv_bwd_w": 50, "matmul_block": 24},
             "ui-chunk": {"conv_block": 70, "matmul_block": 19},
             "tsne": {}, "native": {"conv_block": 0},
             "stream": {"conv_block": 140}, "cloud-data": {"conv_block": 68}}
    b1 = {"kernel": "conv_block", "shape_of": "alexnet-b1.conv1",
          "kernel_route": "direct", "max_abs_err": 1e-6, "kernel_ms": 0.25,
          "plain_ms": 0.5, "bound_ms": 0.0625, "bound_by": "operations",
          "library_ms": 0.125}
    line = {k["name"]: k for k in cs.kernels_line([b1], [], [], paths, {})}
    conv = line["conv_block"]
    assert conv["launches"] == 388
    assert conv["launches_by_path"] == {"ui": 110, "ui-chunk": 70,
                                        "stream": 140, "cloud-data": 68}
    assert line["matmul_block"]["launches_by_path"] == {"ui": 24,
                                                        "ui-chunk": 19}
    assert (conv["alexnet_b1_kernel_ms"], conv["alexnet_b1_route"]) == (
        0.25, "direct")
    cs.check_routes([b1])
    with pytest.raises(RuntimeError, match="expected direct"):
        cs.check_routes([dict(b1, kernel_route="wide")])


def test_png_reader_reads_the_conv_listeners_png():
    from deeplearning4j_tpu_torch.ui.conv_listener import png_gray

    grid = np.random.RandomState(2).randint(0, 256, (9, 31)).astype(np.uint8)
    data = png_gray(grid)
    np.testing.assert_array_equal(cs.read_png_gray(data), grid)
    bad = bytearray(data)
    bad[40] ^= 1  # inside the IDAT chunk
    with pytest.raises(RuntimeError, match="CRC"):
        cs.read_png_gray(bytes(bad))


def test_grids_of_a_cpu_conv_listener_are_its_snapshots_tiles():
    """The [ui-chunk] check on the CPU: a LeNet fit on the scan path with
    the conv listener; its grids are the last minibatch's first row's
    tiles, not the minibatch before's."""
    from deeplearning4j_tpu_torch.ui import ConvolutionalIterationListener

    batches = cs.lenet_batches(4)
    net = MultiLayerNetwork(lenet(), device="cpu").init()
    conv = ConvolutionalIterationListener(frequency=4)
    net.set_listeners(conv)
    net.fit(batches)
    assert net._last_features is batches[-1].features
    diffs = cs.grids_against("t", conv.last_grids, net.feed_forward(
        batches[-1].features[:1]), net.layer_names)
    assert diffs == {"0": 0, "1": 0, "2": 0, "3": 0}
    prev = cs.grid_diffs("t", conv.last_grids, net.feed_forward(
        batches[-2].features[:1]), net.layer_names)
    assert max(prev.values()) > 1


@pytest.mark.parametrize("n", [1000, 1 << 20])
def test_f32_mean_rtol_bounds_numpys_float32_mean(n):
    rng = np.random.RandomState(n % 97)
    for scale in (1e-2, 1.0):
        a = np.abs(rng.randn(n).astype(np.float32) * scale)
        exact = float(np.mean(a.astype(np.float64)))
        assert abs(float(np.mean(a)) - exact) / exact <= cs.f32_mean_rtol(n)


def test_tsne_points_are_seeded_clusters():
    x, labels = cs.tsne_points()
    assert x.shape == (cs.TSNE_N, cs.TSNE_DIM) == (5000, 128)
    assert set(np.unique(labels)) == set(range(cs.TSNE_CLUSTERS))
    x2, _ = cs.tsne_points()
    np.testing.assert_array_equal(x, x2)
