"""The port's training UI (``deeplearning4j_tpu_torch/ui``) against the
JAX package's, on the CPU.

A narrow LeNet built by the JAX package carries its initial weights
into the port (``params_from_numpy``); both fit the same zero-free
numpy batches with SGD (no pre-activation exactly 0, so the two relu
gradients agree). Scores, parameter and update magnitudes and
histogram edges are held at ``kernel_tols()`` (f32: rtol 2e-4, atol
2e-5, the same sums in other orders); histogram counts sum to the
same size; the graph JSON and the record encoding are byte for byte
the JAX package's. Conv-activation grids agree within 1 gray level.
Every server binds port 0 (the tests run under xdist).
"""

import ast
import base64
import io
import json
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from conftest import kernel_tols
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu import ui as jui
from deeplearning4j_tpu_torch import ui
from deeplearning4j_tpu_torch.datasets import ChunkedDataSet, DataSet
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ui.conv_listener import png_gray
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

ROOT = Path(__file__).resolve().parent.parent


def narrow_lenet():
    return (
        JNeuralNetConfiguration.Builder().seed(7).updater("SGD")
        .learning_rate(0.1)
        .list()
        .layer(JConv(n_out=4, kernel_size=(5, 5), activation="relu"))
        .layer(JPool(pooling_type="MAX"))
        .layer(JConv(n_out=6, kernel_size=(5, 5), activation="relu"))
        .layer(JPool(pooling_type="MAX"))
        .layer(JDense(n_out=32, activation="relu"))
        .layer(JOutput(n_out=10, loss="MCXENT"))
        .set_input_type(JInputType.convolutional_flat(28, 28, 1))
        .build()
    )


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _pair():
    jconf = narrow_lenet()
    jnet = JMultiLayerNetwork(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jconf.to_dict()), device="cpu").init(
            params=params_from_numpy(_flat(jnet.params), "cpu"))
    return jnet, net


def _batches(n, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    return [DataSet((rng.rand(batch, 784) * 0.9 + 0.05).astype(np.float32),
                    np.eye(10, dtype=np.float32)[rng.randint(0, 10, batch)])
            for _ in range(n)]


def _jax(batches):
    return [JDataSet(b.features, b.labels) for b in batches]


@pytest.fixture(scope="module")
def records():
    """Both packages' StatsListener records of the same 4-step fit."""
    jnet, net = _pair()
    batches = _batches(4)
    jst, st = jui.InMemoryStatsStorage(), ui.InMemoryStatsStorage()
    jnet.set_listeners(jui.StatsListener(jst, frequency=2,
                                         collect_histograms=True,
                                         session_id="s"))
    net.set_listeners(ui.StatsListener(st, frequency=2,
                                       collect_histograms=True,
                                       session_id="s"))
    jnet.fit(_jax(batches))
    net.fit(batches)
    return jst, st, jnet, net


def test_stats_records_match_jax(records):
    jst, st, jnet, net = records
    rtol, atol = kernel_tols()
    jups, ups = (s.get_all_updates("s", "worker-0") for s in (jst, st))
    assert [u.iteration for u in ups] == [u.iteration for u in jups] == [2, 4]
    np.testing.assert_allclose([u.score for u in ups],
                               [u.score for u in jups], rtol=rtol, atol=atol)
    for u, j in zip(ups, jups):
        assert u.learning_rates == j.learning_rates
        for key in ("param_mean_magnitudes", "update_mean_magnitudes"):
            got, ref = getattr(u, key), getattr(j, key)
            assert sorted(got) == sorted(ref)
            np.testing.assert_allclose([got[k] for k in sorted(ref)],
                                       [ref[k] for k in sorted(ref)],
                                       rtol=rtol, atol=atol, err_msg=key)
        assert sorted(u.param_histograms) == sorted(j.param_histograms)
        for k, h in j.param_histograms.items():
            g = u.param_histograms[k]
            np.testing.assert_allclose([g["min"], g["max"]],
                                       [h["min"], h["max"]],
                                       rtol=rtol, atol=atol, err_msg=k)
            assert sum(g["counts"]) == sum(h["counts"])
            assert len(g["counts"]) == len(h["counts"]) == 20
    assert ups[0].update_mean_magnitudes == {}  # no previous sample
    jstatic, static = (s.get_static_info("s", "worker-0") for s in (jst, st))
    assert static.model["graph_json"] == jstatic.model["graph_json"]
    assert static.model["layers"] == jstatic.model["layers"]
    assert static.model["n_params"] == jstatic.model["n_params"]
    assert static.software["torch"] == torch.__version__
    assert static.hardware == {"backend": "cpu", "device_count": "1",
                               "devices": "cpu"}


def test_report_reads_a_captured_chunks_tensors_as_fresh_copies():
    """The report's previous parameters are copies: an in-place write to
    the model's tensors (a captured chunk's static trees) after a sample
    still shows as an update at the next one."""
    _, net = _pair()
    st = ui.InMemoryStatsStorage()
    lis = ui.StatsListener(st, frequency=1, session_id="c",
                           defer_score_read=False)
    lis.iteration_done(net, 1)
    with torch.no_grad():
        for lp in net.params.values():
            for t in lp.values():
                t.add_(1.0)
    lis.iteration_done(net, 2)
    ups = st.get_all_updates("c", "worker-0")
    assert all(abs(v - 1.0) < 1e-6
               for v in ups[1].update_mean_magnitudes.values())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_file_storage_is_read_by_the_other_package(records, tmp_path,
                                                   writer):
    jst, st, _, _ = records
    src = st if writer == "port" else jst
    path = str(tmp_path / "stats.jsonl")
    out = (ui if writer == "port" else jui).FileStatsStorage(path)
    out.put_static_info(src.get_static_info("s", "worker-0"))
    for u in src.get_all_updates("s", "worker-0"):
        out.put_update(u)
    back = (jui if writer == "port" else ui).FileStatsStorage(path)
    assert back.list_session_ids() == ["s"]
    got = back.get_all_updates("s", "worker-0")
    assert [u.encode() for u in got] == [
        u.encode() for u in src.get_all_updates("s", "worker-0")]
    assert (back.get_static_info("s", "worker-0").encode()
            == src.get_static_info("s", "worker-0").encode())
    # the encoding itself is the JAX package's, byte for byte
    rec = src.get_all_updates("s", "worker-0")[-1]
    assert (ui.decode_record(rec.encode()).encode()
            == jui.decode_record(rec.encode()).encode() == rec.encode())


@pytest.mark.parametrize("sender", ["port", "jax"])
def test_remote_router_posts_to_the_other_packages_server(records, sender):
    jst, st, _, _ = records
    src = st if sender == "port" else jst
    server = (jui if sender == "port" else ui).UIServer(port=0)
    try:
        server.enable_remote_listener()
        router = (ui if sender == "port" else jui).RemoteUIStatsStorageRouter(
            f"http://127.0.0.1:{server.port}", raise_on_error=True)
        router.put_static_info(src.get_static_info("s", "worker-0"))
        for u in src.get_all_updates("s", "worker-0"):
            router.put_update(u)
        held = server.primary_storage()
        assert [u.encode() for u in held.get_all_updates("s", "worker-0")] \
            == [u.encode() for u in src.get_all_updates("s", "worker-0")]
    finally:
        server.stop()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        assert r.status == 200
        return r.read()


def test_endpoints_answer_the_jax_packages_json(records):
    """Both servers over the same records (the JAX package's, decoded by
    each) answer every JSON endpoint alike; ``/debugz`` and ``/metrics``
    answer 200 (their versions and registries are each package's)."""
    jst, _, _, _ = records
    lines = [jst.get_static_info("s", "worker-0").encode()] + [
        u.encode() for u in jst.get_all_updates("s", "worker-0")]
    servers = []
    try:
        for pkg in (ui, jui):
            storage = pkg.InMemoryStatsStorage()
            for line in lines:
                rec = pkg.decode_record(line)
                if isinstance(rec, pkg.StatsInitializationReport):
                    storage.put_static_info(rec)
                else:
                    storage.put_update(rec)
            srv = pkg.UIServer(port=0)
            srv.attach(storage)
            srv.set_activations({"0": "AAAA"})
            srv.set_tsne_vectors([[0.0, 1.0], [2.0, 3.0]], ["a", "b"])
            servers.append(srv)
        for path in ("/train/sessions", "/train/overview?sid=s",
                     "/train/histograms?sid=s", "/train/model?sid=s",
                     "/train/system?sid=s", "/train/graph?sid=s",
                     "/train/activations", "/train/tsne"):
            got, ref = (json.loads(_get(s.port, path)) for s in servers)
            assert got == ref, path
        for path in ("/", "/debugz", "/metrics",
                     "/metrics?format=prometheus"):
            _get(servers[0].port, path)
        dbg = json.loads(_get(servers[0].port, "/debugz"))
        assert dbg["versions"]["torch"] == torch.__version__
        assert dbg["hardware"]["devices"] == "cpu"
        # the page's t-SNE runs on the CPU, 2-d coordinates back
        servers[0].set_tsne_vectors(np.random.RandomState(0).randn(12, 5))
        assert np.shape(servers[0].tsne_coords()["coords"]) == (12, 2)
    finally:
        for s in servers:
            s.stop()


def _decode(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def test_conv_listener_grids_match_jax_within_one_gray_level():
    jnet, net = _pair()
    batches = _batches(2, seed=5)
    jl = jui.ConvolutionalIterationListener(frequency=2)
    pl = ui.ConvolutionalIterationListener(frequency=2)
    jnet.set_listeners(jl)
    net.set_listeners(pl)
    net.scan_chunk = 1
    jnet.scan_chunk = 1
    jnet.fit(_jax(batches))
    net.fit(batches)
    assert sorted(pl.last_grids) == sorted(jl.last_grids) == [
        "0", "1", "2", "3"]
    for name, b64 in jl.last_grids.items():
        ref, got = _decode(b64), _decode(pl.last_grids[name])
        assert got.dtype == np.uint8 and got.shape == ref.shape
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, name


# no module of the port imports an imaging package (the card's machine
# has none: the LFW reader decodes with datasets/imagefile.py)


def test_png_encoder_is_decoded_by_pil_and_imports_no_imaging_package():
    grid = np.random.RandomState(3).randint(0, 256, (7, 13)).astype(np.uint8)
    data = png_gray(grid)
    img = Image.open(io.BytesIO(data))
    assert img.mode == "L" and img.size == (13, 7)
    np.testing.assert_array_equal(np.asarray(img), grid)
    for path in sorted((ROOT / "deeplearning4j_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n.split(".")[0] == "PIL" for n in names), path


def _snapshot_after(pkg_net, listener, batches, **fit_kw):
    pkg_net.set_listeners(listener)
    pkg_net.fit(batches, **fit_kw)
    return pkg_net._last_features


@pytest.mark.parametrize("path", ["per-step", "megastep", "scan-chunk",
                                  "device-cached", "prestacked"])
def test_last_features_on_each_fit_path_match_jax(path):
    """The snapshot a conv listener reads is the last minibatch's
    features on every fit path, as JAX's, and is the caller's own
    array (never a chunk's static buffer)."""
    jnet, net = _pair()
    batches = _batches(5, seed=11)
    kw, jkw = {}, {}
    if path == "per-step":
        net.scan_chunk = jnet.scan_chunk = 1
    elif path == "megastep":
        kw = jkw = {"megastep": 2}
    elif path == "device-cached":
        kw = jkw = {"epochs": 2}
    if path == "prestacked":
        stacked = np.stack([b.features for b in batches[:4]])
        labels = np.stack([b.labels for b in batches[:4]])
        data = [ChunkedDataSet(stacked, labels)]
        from deeplearning4j_tpu.datasets.api import (
            ChunkedDataSet as JChunkedDataSet,
        )
        jdata = [JChunkedDataSet(stacked, labels)]
    else:
        data, jdata = batches, _jax(batches)
    got = _snapshot_after(net, ui.ConvolutionalIterationListener(), data,
                          **kw)
    ref = _snapshot_after(jnet, jui.ConvolutionalIterationListener(), jdata,
                          **jkw)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    if path == "prestacked":
        np.testing.assert_array_equal(got, stacked[-1])
    else:
        assert got is batches[-1].features
    assert net.iteration_count == jnet.iteration_count


@pytest.mark.parametrize("path", ["megastep-chunk", "scan-chunk",
                                  "megastep-placed", "scan-placed"])
def test_snapshot_of_a_placed_payload_is_taken_after_its_copies(
        path, monkeypatch):
    """A prefetch worker places a block (``PlacedChunk``) or a minibatch
    (``PlacedDataSet``) on its own copy stream; the engines wait on its
    copies (``wait``) before they clone the snapshot on the compute
    stream, never the other way round, and the snapshot is the last
    minibatch's rows."""
    from deeplearning4j_tpu_torch.datasets import api
    from deeplearning4j_tpu_torch.nn import core

    events = []
    note = core.note_last_features

    def wait_spy(obj):  # the CPU has no copy stream to wait on
        if obj.ready is not None:
            events.append("wait")
            obj.ready = None

    def note_spy(model, features):
        events.append("snapshot")
        note(model, features)

    monkeypatch.setattr(api, "_wait_placed", wait_spy)
    monkeypatch.setattr(core, "note_last_features", note_spy)
    _, net = _pair()
    batches = _batches(4, seed=5)
    pending = object()  # stands for a copy stream's event not yet waited
    if path.endswith("chunk"):
        data = [api.PlacedChunk(
            torch.from_numpy(np.stack([b.features for b in batches])),
            torch.from_numpy(np.stack([b.labels for b in batches])),
            ready=pending)]
        want = ["wait", "snapshot"]
    else:
        data = [api.PlacedDataSet(torch.from_numpy(b.features),
                                  torch.from_numpy(b.labels),
                                  ready=pending) for b in batches]
        want = ["wait"] * 4 + ["snapshot"]
    kw = {"megastep": 4} if path.startswith("megastep") else {}
    net.set_listeners(ui.ConvolutionalIterationListener())
    net.fit(data, **kw)
    assert events == want
    np.testing.assert_array_equal(net._last_features.numpy(),
                                  batches[-1].features)


def test_no_snapshot_without_a_listener_that_asks():
    _, net = _pair()
    net.set_listeners(ui.StatsListener(ui.InMemoryStatsStorage()))
    net.fit(_batches(2))
    assert getattr(net, "_last_features", None) is None
