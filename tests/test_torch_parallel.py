"""The port's data-parallel training (``parallel/``) on the CPU, against
its own single-process fit and the JAX package's ``DistributedTrainer``
on ``build_mesh(data=4)`` (the 8 virtual devices of conftest).

Each rank is a subprocess that imports only torch, numpy and the port
(``_CHILD``, as ``bench.py``'s ``_DP_CHILD``): the ranks form a gloo
group through a file under ``tmp_path`` (never a fixed TCP port: the
suite runs on several workers at once), run one scenario and write
``.npz`` results. Every multi-process run has a timeout of its own: it
kills its ranks and fails with their stderr, so a hung collective
cannot eat the suite's clock.

Tolerances: the same math summed in another order (the ranks' shards
added by the all-reduce, BatchNormalization's statistics from summed
shards): ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5), as the JAX
package's own DP tests hold theirs (``tests/test_parallel.py``:
rtol 2e-4 / 1e-5). ZeRO against replication is held bitwise: every
updater rule is elementwise.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.datasets.api import ListDataSetIterator as JList
from deeplearning4j_tpu.datasets.api import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.parallel import DistributedTrainer as JTrainer
from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper
from deeplearning4j_tpu.parallel import build_mesh as jbuild_mesh
from deeplearning4j_tpu.zoo import models as jax_zoo
from deeplearning4j_tpu_torch.datasets import (
    DataSet,
    ListDataSetIterator,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalization,
    DenseLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    DistributedTrainer,
    ParallelWrapper,
    build_mesh,
    process_local_batch,
)
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy
from deeplearning4j_tpu_torch.zoo import resnet50

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 180

# One rank of a scenario. argv[1]: a JSON spec (scenario, rank, world,
# rendezvous file, data / init / output paths, trainer options).
_CHILD = r"""
import json, sys
import numpy as np
import torch
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    DistributedTrainer, build_mesh, init_distributed, shutdown_distributed)
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy, params_to_numpy, updater_state_to_numpy, write_model)
from deeplearning4j_tpu_torch.nn.conf import (
    ComputationGraphConfiguration, MultiLayerConfiguration)

spec = json.loads(sys.argv[1])
init_distributed("file://" + spec["rdv"], spec["world"], spec["rank"],
                 device="cpu", timeout_s=120)
mesh = build_mesh(data=spec["world"])
conf_d = json.loads(open(spec["conf"]).read())
if "vertices" in conf_d:
    model = ComputationGraph(ComputationGraphConfiguration.from_dict(conf_d),
                             device="cpu")
else:
    model = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf_d),
                              device="cpu")
if spec.get("init"):
    model.init(params=params_from_numpy(dict(np.load(spec["init"])), "cpu"))
else:
    model.init()
data = np.load(spec["data"])
feats = [data[k] for k in sorted(data.files) if k.startswith("x")]
labels = [data[k] for k in sorted(data.files) if k.startswith("y")]
if isinstance(model, ComputationGraph):
    ds = MultiDataSet(feats, labels)
else:
    ds = DataSet(feats[0], labels[0])
out = {}
try:
    tr = DistributedTrainer(model, mesh=mesh,
                            batch_stats=spec.get("batch_stats", "auto"),
                            zero=spec.get("zero", False))
    if spec.get("grad_accum"):
        core.set_grad_accum(model, spec["grad_accum"])
    scores = [float(tr.fit_minibatch(ds)) for _ in range(spec["steps"])]
    out["scores"] = np.asarray(scores)
    out["rows"] = np.asarray(model._last_batch_rows)
    out["upd_bytes"] = np.asarray(tr.updater_state_bytes_per_device)
    out["zero_bytes"] = np.asarray(tr.zero_shard_bytes)
    for k, v in params_to_numpy(model.params).items():
        out["p:" + k] = v
    for k, v in updater_state_to_numpy(tr.gather_updater_state()).items():
        out["u:" + k] = v
    for ln, st in model.state.items():
        for k, v in st.items():
            out["s:" + ln + "/" + k] = v.numpy()
    # ZeRO-1's layout follow-ups: a checkpoint, a second trainer over the
    # same model, then the engine's own fit, each on every rank
    if spec.get("ckpt"):
        write_model(model, spec["ckpt"])
    if spec.get("trainer2_steps"):
        tr = DistributedTrainer(model, mesh=mesh,
                                batch_stats=spec.get("batch_stats", "auto"),
                                zero=spec.get("zero", False))
        out["scores2"] = np.asarray([float(tr.fit_minibatch(ds))
                                     for _ in range(spec["trainer2_steps"])])
    if spec.get("engine_steps"):
        out["scores3"] = np.asarray([float(model.fit_minibatch(ds))
                                     for _ in range(spec["engine_steps"])])
        out["layout"] = np.asarray(str(model._zero_layout))
        for k, v in params_to_numpy(model.params).items():
            out["p3:" + k] = v
        for k, v in updater_state_to_numpy(model.updater_state).items():
            out["u3:" + k] = v
except ValueError as e:
    out["error"] = np.asarray(str(e))
np.savez(spec["out"], **out)
shutdown_distributed()
"""


def _save_conf(tmp_path, conf) -> str:
    path = tmp_path / "conf.json"
    path.write_text(json.dumps(conf.to_dict()))
    return str(path)


def run_ranks(tmp_path, world, conf, arrays, steps=1, init=None, **opts):
    """Run ``_CHILD`` on ``world`` gloo ranks; returns each rank's
    results. A run past RANK_TIMEOUT_S kills every rank and fails with
    their stderr."""
    run = tmp_path / f"run{len(list(tmp_path.glob('run*')))}"
    run.mkdir()
    np.savez(run / "data.npz", **arrays)
    if init is not None:
        np.savez(run / "init.npz", **init)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        spec = dict(rank=r, world=world, rdv=str(run / "rdv"),
                    conf=_save_conf(run, conf), data=str(run / "data.npz"),
                    init=str(run / "init.npz") if init is not None else "",
                    out=str(run / f"out{r}.npz"), steps=steps,
                    **{k: (v.format(rank=r) if isinstance(v, str) else v)
                       for k, v in opts.items()})
        logs.append(run / f"err{r}.txt")
        with open(logs[-1], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD, json.dumps(spec)],
                cwd=str(ROOT), env=env, stdout=subprocess.DEVNULL,
                stderr=err))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"ranks hung past {RANK_TIMEOUT_S} s:\n" + "\n---\n".join(
            log.read_text()[-2000:] for log in logs))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-4000:]
    return [dict(np.load(run / f"out{r}.npz")) for r in range(world)]


def _params(res):
    return {k[2:]: v for k, v in res.items() if k.startswith("p:")}


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _assert_close_trees(got, want, rtol, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _assert_replicas_equal(results):
    for r in results[1:]:
        for k, v in results[0].items():
            np.testing.assert_array_equal(r[k], v, err_msg=k)


# -- models and data (the JAX package's tests/test_parallel.py) -------------


def mlp_conf(seed=5, lr=0.2, updater="SGD", bn=False):
    b = (NeuralNetConfiguration.Builder().seed(seed).learning_rate(lr)
         .updater(updater).list()
         .layer(DenseLayer(n_in=6, n_out=16, activation="tanh")))
    if bn:
        b.layer(BatchNormalization(n_out=16))
    return b.layer(OutputLayer(n_out=3)).build()


def blob_data(rng, n=64):
    centers = rng.randn(3, 6) * 3
    x = np.stack([centers[i % 3] + 0.3 * rng.randn(6) for i in range(n)])
    y = np.eye(3)[np.arange(n) % 3]
    return x.astype(np.float32), y.astype(np.float32)


def tiny_resnet(**kw):
    return dict(height=8, width=8, channels=1, n_classes=3, cifar_stem=True,
                depths=(1, 1), base_width=4, learning_rate=0.05, **kw)


def resnet_batch(seed=0, n=8):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 1, 8, 8).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return x, y


def _single_fit(conf, ds, steps, init=None):
    model = (ComputationGraph if hasattr(conf, "vertices")
             else MultiLayerNetwork)(conf, device="cpu")
    model.init(params=None if init is None
               else params_from_numpy(init, "cpu"))
    scores = [float(model.fit_minibatch(ds)) for _ in range(steps)]
    return model, scores


# -- the mesh -------------------------------------------------------------


def test_mesh_of_one_process_and_its_refusals(tmp_path):
    mesh = build_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.backend is None
    assert process_local_batch(64, mesh) == 64
    # a model axis needs a world it divides (JAX's message)
    with pytest.raises(ValueError, match="not divisible by model=2"):
        build_mesh(model=2)
    with pytest.raises(ValueError, match="world size"):
        build_mesh(data=4)
    net = MultiLayerNetwork(mlp_conf(), device="cpu").init()
    with pytest.raises(ValueError, match="auto\\|sync\\|local"):
        DistributedTrainer(net, batch_stats="bogus")
    # tensor parallelism is ported: over a model axis of one it is the
    # replicated trainer, and JAX's refusal of ZeRO with it holds
    assert not DistributedTrainer(net, tensor_parallel=True).tensor_parallel
    with pytest.raises(ValueError, match="zero=True shards"):
        DistributedTrainer(net, tensor_parallel=True, zero=True)
    with pytest.raises(TypeError, match="DivergenceGuard"):
        DistributedTrainer(net, divergence_guard=object())
    with pytest.raises(ValueError, match="zero=True"):
        DistributedTrainer(net, zero=True, batch_stats="local")
    tr = DistributedTrainer(net)
    # megastep, fit_megachunk and resume are carried now (the runtime
    # slice): K = 4 over four batches is one chunk, a chunk of two
    # more, then a fresh trainer resumes the checkpoint of step 6
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
    )

    x, y = blob_data(np.random.RandomState(0), n=24)
    batches = [DataSet(x[i:i + 4], y[i:i + 4]) for i in range(0, 24, 4)]
    assert np.isfinite(tr.fit(batches[:4], megastep=4)[0])
    assert net.iteration_count == 4 and net.megastep == 4
    assert tr.fit_megachunk(batches[4:]) == net.score_value
    assert net.iteration_count == 6
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(net)
    fresh = MultiLayerNetwork(mlp_conf(), device="cpu").init()
    assert DistributedTrainer(fresh).resume(mgr) == 6
    assert all(torch.equal(t, net.params[ln][pn])
               for ln, lp in fresh.params.items() for pn, t in lp.items())
    with pytest.raises(TypeError, match="DivergenceGuard"):
        tr.set_divergence_guard(object())


def test_one_process_trainer_is_the_plain_fit_bitwise(rng):
    """A world of one process: the trainer's step is the engine's."""
    x, y = blob_data(rng, n=32)
    ds = DataSet(x, y)
    single, s1 = _single_fit(mlp_conf(updater="ADAM", lr=0.05), ds, 4)
    net = MultiLayerNetwork(mlp_conf(updater="ADAM", lr=0.05),
                            device="cpu").init()
    tr = DistributedTrainer(net)
    s2 = [float(tr.fit_minibatch(ds)) for _ in range(4)]
    assert s1 == s2
    for ln, lp in single.params.items():
        for pn, t in lp.items():
            assert torch.equal(t, net.params[ln][pn])


def test_dp_trainer_fit_over_epochs(rng):
    """``fit(iterator, epochs)``: one step a minibatch, the per-epoch mean
    scores returned, the iterator reset after each epoch; Adam halves
    the score (the JAX package's test_dp_trainer_adam_and_listeners)."""
    x, y = blob_data(rng, n=64)
    net = MultiLayerNetwork(mlp_conf(updater="ADAM", lr=0.05),
                            device="cpu").init()
    tr = DistributedTrainer(net)
    it = ListDataSetIterator([DataSet(x[:32], y[:32]),
                              DataSet(x[32:], y[32:])])
    s0 = net.score(x=x, labels=y)
    scores = tr.fit(it, epochs=15)
    assert len(scores) == 15 and net.iteration_count == 30
    assert net.epoch_count == 15 and scores[-1] < scores[0]
    assert net.score(x=x, labels=y) < s0 * 0.5


# -- DistributedTrainer on gloo ranks ----------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_dp_trainer_matches_single_device_and_jax(tmp_path, rng, world):
    """Per-step all-reduce on ``world`` ranks equals training on one
    device with the whole batch (the port's and the JAX package's)."""
    x, y = blob_data(rng, n=64)
    res = run_ranks(tmp_path, world, mlp_conf(), {"x0": x, "y0": y},
                    steps=10)
    _assert_replicas_equal(res)
    single, scores = _single_fit(mlp_conf(), DataSet(x, y), 10)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(res[0]["scores"], scores, rtol=rtol,
                               atol=atol)
    _assert_close_trees(_params(res[0]), _flat(single.params), rtol, atol)
    from deeplearning4j_tpu.nn.conf import (
        NeuralNetConfiguration as JNNC,
    )
    from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
    from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN

    jnet = JMLN(JNNC.Builder().seed(5).learning_rate(0.2).updater("SGD")
                .list().layer(JDense(n_in=6, n_out=16, activation="tanh"))
                .layer(JOut(n_out=3)).build()).init()
    init = {k: v for k, v in _flat(jnet.params).items()}
    res = run_ranks(tmp_path, world, mlp_conf(), {"x0": x, "y0": y},
                    steps=10, init=init)
    jtr = JTrainer(jnet, mesh=jbuild_mesh())
    for _ in range(10):
        jtr.fit_minibatch(JDataSet(features=x, labels=y))
    _assert_close_trees(_params(res[0]), _flat(jnet.params), rtol, atol)


def test_dp_partial_batch_pads_and_masks(tmp_path, rng):
    """30 rows on 4 ranks: padded to 32 with zero rows masked out of the
    loss, so the step equals the unpadded batch's; the rows counted are
    the 30 real ones."""
    x, y = blob_data(rng, n=30)
    res = run_ranks(tmp_path, 4, mlp_conf(), {"x0": x, "y0": y}, steps=3)
    _assert_replicas_equal(res)
    assert int(res[0]["rows"]) == 30
    single, scores = _single_fit(mlp_conf(), DataSet(x, y), 3)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(res[0]["scores"], scores, rtol=rtol,
                               atol=atol)
    _assert_close_trees(_params(res[0]), _flat(single.params), rtol, atol)


def test_dp_partial_batch_with_batchnorm_still_raises(tmp_path, rng):
    x, y = blob_data(rng, n=30)
    res = run_ranks(tmp_path, 4, mlp_conf(bn=True), {"x0": x, "y0": y},
                    steps=1)
    for r in res:
        assert "divisible" in str(r["error"])


def test_dp_trainer_with_computation_graph(tmp_path, rng):
    """A two-input graph (MergeVertex) on 2 ranks: the score falls, and
    the step equals the single-process one."""
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import MergeVertex

    conf = (NeuralNetConfiguration.Builder().seed(2).learning_rate(0.1)
            .graph_builder()
            .add_inputs("a", "b")
            .add_layer("da", DenseLayer(n_in=4, n_out=6, activation="tanh"),
                       "a")
            .add_layer("db", DenseLayer(n_in=4, n_out=6, activation="tanh"),
                       "b")
            .add_vertex("m", MergeVertex(), "da", "db")
            .add_layer("out", OutputLayer(n_in=12, n_out=2), "m")
            .set_outputs("out")
            .build())
    xa = rng.randn(16, 4).astype(np.float32)
    xb = rng.randn(16, 4).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 16)]
    res = run_ranks(tmp_path, 2, conf, {"x0": xa, "x1": xb, "y0": y},
                    steps=10)
    _assert_replicas_equal(res)
    assert res[0]["scores"][-1] < res[0]["scores"][0]
    single, scores = _single_fit(conf, MultiDataSet([xa, xb], [y]), 10)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(res[0]["scores"], scores, rtol=rtol,
                               atol=atol)
    _assert_close_trees(_params(res[0]), _flat(single.params), rtol, atol)


@pytest.fixture(scope="module")
def jax_resnet_init():
    return _flat(JGraph(jax_zoo.resnet50(**tiny_resnet())).init().params)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_tiny_resnet_sync_matches_jax_mesh_and_single(
        tmp_path, world, jax_resnet_init):
    """The residual adds, BN over the global batch (``sync``, the
    default for a BN model) and the projection shortcuts on ``world``
    ranks: the same two steps as the port's single-process fit and as
    the JAX package's DistributedTrainer on build_mesh(data=4)."""
    x, y = resnet_batch()
    res = run_ranks(tmp_path, world, resnet50(**tiny_resnet()),
                    {"x0": x, "y0": y}, steps=2, init=jax_resnet_init,
                    batch_stats="sync")
    _assert_replicas_equal(res)
    single, scores = _single_fit(resnet50(**tiny_resnet()),
                                 MultiDataSet([x], [y]), 2,
                                 init=jax_resnet_init)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(res[0]["scores"], scores, rtol=rtol,
                               atol=atol)
    _assert_close_trees(_params(res[0]), _flat(single.params), rtol, atol)
    jnet = JGraph(jax_zoo.resnet50(**tiny_resnet())).init()
    mesh = jbuild_mesh(data=4, model=1, devices=jax.devices()[:4])
    jtr = JTrainer(jnet, mesh=mesh)
    jscores = [float(jtr.fit_minibatch(JMultiDataSet(features=[x],
                                                     labels=[y])))
               for _ in range(2)]
    np.testing.assert_allclose(res[0]["scores"], jscores, rtol=rtol,
                               atol=atol)
    _assert_close_trees(_params(res[0]), _flat(jnet.params), rtol, atol)
    for key, v in res[0].items():
        if key.startswith("s:"):
            ln, k = key[2:].split("/")
            np.testing.assert_allclose(v, np.asarray(jnet.state[ln][k]),
                                       rtol=rtol, atol=atol, err_msg=key)


def test_dp_local_batch_stats_matches_jax(tmp_path, jax_resnet_init):
    """``batch_stats="local"`` (each rank's BN sees its own 2 rows, the
    reference's workers) on 4 ranks against the JAX package's
    shard_map step on build_mesh(data=4): scores, weights and the
    averaged running statistics."""
    x, y = resnet_batch()
    res = run_ranks(tmp_path, 4, resnet50(**tiny_resnet()),
                    {"x0": x, "y0": y}, steps=3, init=jax_resnet_init,
                    batch_stats="local")
    _assert_replicas_equal(res)
    jnet = JGraph(jax_zoo.resnet50(**tiny_resnet())).init()
    mesh = jbuild_mesh(data=4, model=1, devices=jax.devices()[:4])
    jtr = JTrainer(jnet, mesh=mesh, batch_stats="local")
    jscores = [float(jtr.fit_minibatch(JMultiDataSet(features=[x],
                                                     labels=[y])))
               for _ in range(3)]
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(res[0]["scores"], jscores, rtol=rtol,
                               atol=atol)
    assert res[0]["scores"][-1] < res[0]["scores"][0]
    _assert_close_trees(_params(res[0]), _flat(jnet.params), rtol, atol)
    for key, v in res[0].items():
        if key.startswith("s:"):
            ln, k = key[2:].split("/")
            np.testing.assert_allclose(v, np.asarray(jnet.state[ln][k]),
                                       rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("conf_name", ["mlp_adam", "resnet"])
def test_zero_is_bitwise_equal_to_replicated(tmp_path, rng, conf_name):
    """ZeRO-1 on 2 ranks: the parameters, the gathered updater state and
    the scores equal the replicated run's bit for bit; each rank keeps
    half of the moments (the two byte gauges)."""
    if conf_name == "mlp_adam":
        conf = mlp_conf(updater="ADAM", lr=0.05)
        x, y = blob_data(rng, n=32)
    else:
        conf = resnet50(**tiny_resnet())
        x, y = resnet_batch()
    rep = run_ranks(tmp_path, 2, conf, {"x0": x, "y0": y}, steps=3,
                    batch_stats="sync")
    zero = run_ranks(tmp_path, 2, conf, {"x0": x, "y0": y}, steps=3,
                     batch_stats="sync", zero=True)
    for key, v in rep[0].items():
        if key.startswith(("p:", "u:", "s:")) or key == "scores":
            np.testing.assert_array_equal(zero[0][key], v, err_msg=key)
    total = int(rep[0]["upd_bytes"])
    assert int(rep[0]["zero_bytes"]) == 0
    for r in zero:
        assert int(r["zero_bytes"]) == int(r["upd_bytes"])
        assert total / 2 <= int(r["zero_bytes"]) <= total / 2 + 4 * 64


@pytest.mark.parametrize("world", [1, 2])
def test_zero_layout_checkpoint_second_trainer_and_engine_fit(
        tmp_path, rng, world):
    """ZeRO-1's flat updater layout never leaks: after a ``zero=True``
    fit, ``write_model`` (every rank) writes the parameter-shaped moments,
    equal bit for bit to the replicated run's and loadable by the JAX
    package; a second ``zero=True`` trainer over the same model gathers
    before it re-shards (no slice of a slice) and continues the
    replicated trajectory bit for bit on every rank; the engine's own
    ``fit_minibatch`` then gathers and continues with the replicated
    scores. Held bitwise: every updater rule is elementwise."""
    import zipfile

    from deeplearning4j_tpu.util.model_serializer import (
        restore_multi_layer_network as jrestore,
    )

    conf = mlp_conf(updater="ADAM", lr=0.05)
    x, y = blob_data(rng, n=32)
    runs = {}
    for zero in (False, True):
        ckpt = str(tmp_path / f"ckpt-{zero}-{{rank}}.zip")
        runs[zero] = run_ranks(tmp_path, world, conf, {"x0": x, "y0": y},
                               steps=2, batch_stats="sync", zero=zero,
                               ckpt=ckpt, trainer2_steps=2, engine_steps=2)
    rep, zero = runs[False], runs[True]
    for r in range(world):
        for key, v in rep[0].items():
            if key.startswith(("p:", "u:", "p3:", "u3:", "scores")):
                np.testing.assert_array_equal(zero[r][key], v,
                                              err_msg=f"rank {r} {key}")
        assert str(zero[r]["layout"]) == "None"

    def npz(path, name):
        with zipfile.ZipFile(path) as zf:
            with np.load(__import__("io").BytesIO(zf.read(name))) as f:
                return {k: f[k] for k in f.files}

    want = tmp_path / "ckpt-False-0.zip"
    for r in range(world):
        got = tmp_path / f"ckpt-True-{r}.zip"
        for name in ("coefficients.npz", "updaterState.npz"):
            w, g = npz(want, name), npz(got, name)
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    jnet = jrestore(str(tmp_path / f"ckpt-True-{world - 1}.zip"))
    for ln, lp in jnet.params.items():
        for pn, p in lp.items():
            for leaf in jax.tree_util.tree_leaves(jnet.updater_state[ln][pn]):
                assert leaf.shape == p.shape, (ln, pn, leaf.shape)


def test_dp_grad_accum_matches_the_unaccumulated_step(tmp_path, rng):
    """grad_accum=2 on 2 ranks (each microbatch a whole shard a rank)
    against one unaccumulated single-process step on the whole batch:
    the mean of the two microbatches' mean gradients is the batch's."""
    x, y = blob_data(rng, n=32)
    res = run_ranks(tmp_path, 2, mlp_conf(updater="ADAM", lr=0.05),
                    {"x0": x, "y0": y}, steps=3, grad_accum=2)
    _assert_replicas_equal(res)
    single, scores = _single_fit(mlp_conf(updater="ADAM", lr=0.05),
                                 DataSet(x, y), 3)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(res[0]["scores"], scores, rtol=rtol,
                               atol=atol)
    _assert_close_trees(_params(res[0]), _flat(single.params), rtol, atol)
    odd = run_ranks(tmp_path, 2, mlp_conf(), {"x0": x[:12], "y0": y[:12]},
                    steps=1, grad_accum=4)
    assert "multiple of 8" in str(odd[0]["error"])


def test_engine_grad_accum_matches_unaccumulated_and_jax(rng):
    """The engines' own ``fit(grad_accum=2)``: against the plain step on
    the same batch and against the JAX package's accumulated fit; BN
    configurations refuse it."""
    from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JMLC
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN

    x, y = blob_data(rng, n=32)
    plain = MultiLayerNetwork(mlp_conf(updater="ADAM", lr=0.05),
                              device="cpu")
    acc = MultiLayerNetwork(mlp_conf(updater="ADAM", lr=0.05),
                            device="cpu")
    jnet = JMLN(JMLC.from_dict(mlp_conf(updater="ADAM",
                                        lr=0.05).to_dict())).init()
    init = params_from_numpy(_flat(jnet.params), "cpu")
    plain.init(params=init)
    acc.init(params=init)
    for _ in range(3):
        plain.fit(DataSet(x, y))
        acc.fit(DataSet(x, y), grad_accum=2)
        jnet.fit(JDataSet(features=x, labels=y), grad_accum=2)
    rtol, atol = kernel_tols()
    assert acc.grad_accum == 2 and acc.iteration_count == 3
    np.testing.assert_allclose(acc.score_value, plain.score_value,
                               rtol=rtol, atol=atol)
    _assert_close_trees(_flat(acc.params), _flat(plain.params), rtol, atol)
    _assert_close_trees(_flat(acc.params), _flat(jnet.params), rtol, atol)
    with pytest.raises(ValueError, match="equal"):
        acc.fit(DataSet(x[:7], y[:7]))
    g = ComputationGraph(resnet50(**tiny_resnet()), device="cpu").init()
    with pytest.raises(ValueError, match="BatchNormalization"):
        g.fit(MultiDataSet(*([a] for a in resnet_batch())), grad_accum=2)


# -- ParallelWrapper -------------------------------------------------------


def test_parameter_averaging_equivalence_single_machine(rng):
    """The reference's core distributed test: 4 replicas averaged every
    step under SGD equal one machine on the concatenated batch."""
    x, y = blob_data(rng, n=64)
    single = MultiLayerNetwork(mlp_conf(seed=3, lr=0.3), device="cpu").init()
    for _ in range(8):
        single.fit(x, y)
    wrapped = MultiLayerNetwork(mlp_conf(seed=3, lr=0.3),
                                device="cpu").init()
    pw = ParallelWrapper(wrapped, workers=4, averaging_frequency=1)
    batches = [DataSet(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
    for _ in range(8):
        pw.fit(ListDataSetIterator(batches))
    rtol, atol = kernel_tols()
    _assert_close_trees(_flat(wrapped.params), _flat(single.params), rtol,
                        atol)
    assert wrapped.iteration_count == 8


def test_parameter_averaging_frequency_gt_one_matches_jax(rng):
    """Averaging every 3 rounds lets the replicas drift and re-sync: the
    score falls, and the trajectory (Adam, updaters averaged) follows
    the JAX package's ParallelWrapper."""
    from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JMLC
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN

    x, y = blob_data(rng, n=64)
    conf = mlp_conf(seed=3, lr=0.05, updater="ADAM")
    jnet = JMLN(JMLC.from_dict(conf.to_dict())).init()
    net = MultiLayerNetwork(conf, device="cpu").init(
        params=params_from_numpy(_flat(jnet.params), "cpu"))
    pw = ParallelWrapper(net, workers=4, averaging_frequency=3)
    jpw = JWrapper(jnet, workers=4, averaging_frequency=3,
                   prefetch_buffer=0)
    batches = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
    s0 = net.score(x=x, labels=y)
    for _ in range(6):
        pw.fit(ListDataSetIterator([DataSet(a, b) for a, b in batches]))
        jpw.fit(JList([JDataSet(features=a, labels=b) for a, b in batches]))
    assert net.score(x=x, labels=y) < s0 * 0.5
    rtol, atol = kernel_tols()
    _assert_close_trees(_flat(net.params), _flat(jnet.params), rtol, atol)


def test_parallel_wrapper_carries_and_averages_batchnorm_state(rng):
    """The replicas' BN running statistics move and are averaged: one
    round of 4 replicas at frequency 1 leaves the mean of their four
    statistics (each replica's own step computed alone)."""
    conf = mlp_conf(seed=2, lr=0.1, bn=True)
    x, y = blob_data(rng, n=32)
    net = MultiLayerNetwork(conf, device="cpu").init()
    pw_init = {ln: {pn: t.clone() for pn, t in lp.items()}
               for ln, lp in net.params.items()}
    m0 = net.state["1"]["mean"].clone()
    pw = ParallelWrapper(net, workers=4, averaging_frequency=1,
                         prefetch_buffer=0)
    batches = [DataSet(x[i:i + 8], y[i:i + 8]) for i in range(0, 32, 8)]
    pw.fit(ListDataSetIterator(batches))
    assert not torch.allclose(net.state["1"]["mean"], m0)
    want = {"mean": [], "var": []}
    for ds in batches:
        solo = MultiLayerNetwork(conf, device="cpu").init()
        solo.fit(ds)
        for k in want:
            want[k].append(solo.state["1"][k])
    for k, v in want.items():
        torch.testing.assert_close(net.state["1"][k],
                                   torch.stack(v).mean(0))
    # prefetch_buffer is carried now (JAX's default, 2): the same
    # averaged statistics through the prefetching pipeline
    pre = MultiLayerNetwork(conf, device="cpu").init(params=pw_init)
    ParallelWrapper(pre, workers=4, averaging_frequency=1,
                    prefetch_buffer=2).fit(ListDataSetIterator(batches))
    for k in want:
        assert torch.equal(pre.state["1"][k], net.state["1"][k])
