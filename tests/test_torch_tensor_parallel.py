"""The port's tensor parallelism (``parallel/tensor_parallel.py``,
``DistributedTrainer(tensor_parallel=True)`` over ``build_mesh(data,
model)``) on the CPU, against the JAX package's GSPMD trainer on the
same meshes (conftest's 8 virtual devices).

One gloo world of four port ranks runs every case of this module
(``tests/torch_world.py``), carried in from the JAX nets' initial
weights; the JAX side trains while the ranks run. The cases: JAX
``tests/test_parallel.py``'s MLP at ``model=4`` (its 3-class head does
not divide and stays replicated), a narrow LeNet at ``data=2 x
model=2`` (the convolutions split on out-channels, the dense layers on
columns), a masked LSTM net at ``data=2 x model=2`` (its weights
gathered whole before the layer), a save from the tensor-parallel
world that the JAX package loads, and its restore re-sharded at another
mesh.

Tolerance: ``kernel_tols()``: the same math, summed in another order
(GSPMD's collectives against the port's gathers and all-reduces).
"""

import json

import jax
import numpy as np
import pytest

from conftest import kernel_tols
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import GravesLSTM as JLSTM
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import DistributedTrainer as JTrainer
from deeplearning4j_tpu.parallel import build_mesh as jbuild_mesh
from deeplearning4j_tpu.util.model_serializer import (
    restore_model as jrestore_model,
)
from deeplearning4j_tpu.zoo import models as jax_zoo
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    DistributedTrainer,
    build_mesh,
    tensor_parallel,
)
from deeplearning4j_tpu_torch.util.model_serializer import restore_model
from torch_world import RankWorld, save_arrays

WORLD = 4

_SCRIPT = r"""
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import DistributedTrainer, build_mesh
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy, params_to_numpy, restore_model, write_model)
import torch.distributed as dist

mesh = build_mesh(data=2, model=2)
OUT["mesh"] = np.asarray(
    [mesh.data_index, mesh.model_index]
    + dist.get_process_group_ranks(mesh.data_group)
    + dist.get_process_group_ranks(mesh.model_group))


def dataset(d):
    return DataSet(d["x"], d["y"],
                   features_mask=d["m"] if "m" in d.files else None,
                   labels_mask=d["m"] if "m" in d.files else None)


for case in spec["cases"]:
    tag = case["tag"]
    conf = MultiLayerConfiguration.from_dict(json.loads(case["conf"]))
    net = MultiLayerNetwork(conf, device="cpu").init(
        params=params_from_numpy(dict(np.load(case["init"])), "cpu"))
    d = np.load(case["data"])
    ds = dataset(d)
    model = case["model"]
    tr = DistributedTrainer(net, mesh=build_mesh(data=WORLD // model,
                                                 model=model),
                            tensor_parallel=True)
    OUT[tag + ":shapes"] = np.asarray(json.dumps(
        {f"{ln}/{pn}": list(p.shape) for ln, lp in net.params.items()
         for pn, p in lp.items()}))
    OUT[tag + ":scores"] = np.asarray(
        [float(tr.fit_minibatch(ds)) for _ in range(case["steps"])])
    for k, v in params_to_numpy(core.canonical_trees(net)[0]).items():
        OUT[f"{tag}:p:{k}"] = v
    OUT[tag + ":out"] = net.output(
        d["x"], features_mask=d["m"] if "m" in d.files else None).numpy()
    if case.get("ckpt"):
        # every rank gathers; each writes a file of its own
        path = case["ckpt"].format(rank=RANK)
        write_model(net, path)
        back = restore_model(path, device="cpu")
        tr2 = DistributedTrainer(back, mesh=build_mesh(data=2, model=2),
                                 tensor_parallel=True)
        OUT[tag + ":resumed"] = np.asarray(float(tr2.fit_minibatch(ds)))
        for k, v in params_to_numpy(core.canonical_trees(back)[0]).items():
            OUT[f"{tag}:r:{k}"] = v
# a model no trainer sharded, beside the tensor-parallel LSTM net above,
# whose LSTM W has the shape of that net's shard: it runs whole, alone
assert net._tp_layout
other = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
    json.loads(spec["other"])), device="cpu").init()
OUT["other:out"] = other.output(d["x"], features_mask=d["m"]).numpy()
save()
shutdown_distributed()
"""


def blob_data(rng, n=64):
    centers = rng.randn(3, 6) * 3
    x = np.stack([centers[i % 3] + 0.3 * rng.randn(6) for i in range(n)])
    y = np.eye(3)[np.arange(n) % 3]
    return x.astype(np.float32), y.astype(np.float32)


def mlp_jconf(seed=9, lr=0.2):
    """JAX ``tests/test_parallel.py``'s ``make_net`` configuration."""
    return (JBuilder.Builder().seed(seed).learning_rate(lr).updater("SGD")
            .list()
            .layer(JDense(n_in=6, n_out=16, activation="tanh"))
            .layer(JOutput(n_out=3))
            .build())


def lenet_jconf():
    return jax_zoo.lenet(height=16, width=16, n_classes=4, dense_width=32)


def lstm_jconf(n_out=8):
    return (JBuilder.Builder().seed(4).learning_rate(0.1).updater("ADAM")
            .list()
            .layer(JLSTM(n_out=n_out))
            .layer(JRnnOutput(n_out=2))
            .set_input_type(JInputType.recurrent(3))
            .build())


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _jax_ds(d):
    m = d.get("m")
    return JDataSet(features=d["x"], labels=d["y"], features_mask=m,
                    labels_mask=m)


# (tag, JAX configuration, data, port mesh's model axis, JAX mesh, steps)
def _cases():
    rng = np.random.RandomState(0)
    x, y = blob_data(rng, n=32)
    img = rng.rand(8, 256).astype(np.float32)
    lab = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 8)]
    seq = rng.randn(8, 3, 6).astype(np.float32)
    seq_y = np.zeros((8, 2, 6), np.float32)
    seq_y[:, 0, :3] = 1.0
    seq_y[:, 1, 3:] = 1.0
    mask = np.ones((8, 6), np.float32)
    mask[:, 4:] = 0.0
    devs = jax.devices()[:4]
    return [
        ("mlp", mlp_jconf(), {"x": x, "y": y}, 4,
         lambda: jbuild_mesh(model=4, devices=devs), 5),
        ("lenet", lenet_jconf(), {"x": img, "y": lab}, 2,
         lambda: jbuild_mesh(data=2, model=2, devices=devs), 3),
        ("lstm", lstm_jconf(), {"x": seq, "y": seq_y, "m": mask}, 2,
         lambda: jbuild_mesh(data=2, model=2, devices=devs), 3),
    ]


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    """The port's world (started first), then the JAX side's results."""
    run = tmp_path_factory.mktemp("tp")
    cases, jax_nets, specs = _cases(), {}, []
    for tag, jconf, data, model, _, steps in cases:
        jnet = JNet(jconf).init()
        jax_nets[tag] = jnet
        specs.append(dict(
            tag=tag, conf=jconf.to_json(), model=model, steps=steps,
            init=save_arrays(run / f"{tag}_init.npz", _flat(jnet.params)),
            data=save_arrays(run / f"{tag}_data.npz", data),
            ckpt=str(run / f"{tag}_ckpt{{rank}}.zip") if tag == "mlp"
            else ""))
    world = RankWorld.start(run, WORLD, _SCRIPT, {
        "cases": specs, "other": lstm_jconf(n_out=4).to_json()})
    try:
        jax_out = {}
        for tag, jconf, data, _, jmesh, steps in cases:
            jnet = jax_nets[tag]
            jtr = JTrainer(jnet, mesh=jmesh(), tensor_parallel=True)
            scores = [float(jtr.fit_minibatch(_jax_ds(data)))
                      for _ in range(steps)]
            jax_out[tag] = (scores, _flat(jnet.params), data)
        results = world.wait()
    finally:
        world.kill()
    return results, jax_out, run


def _port_params(res, tag, key="p"):
    pre = f"{tag}:{key}:"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def test_mesh_is_row_major_with_both_axes_groups(tp_world):
    results, _, _ = tp_world
    for r, res in enumerate(results):
        di, mi, *groups = res["mesh"].tolist()
        assert (di, mi) == (r // 2, r % 2)
        assert groups[:2] == [mi, mi + 2]          # same model index
        assert groups[2:] == [2 * di, 2 * di + 1]  # same data index


@pytest.mark.parametrize("tag", ["mlp", "lenet", "lstm"])
def test_tensor_parallel_matches_jax_gspmd(tp_world, tag):
    """Scores, the gathered weights and the output after training against
    the JAX trainer's on the same mesh; every rank gathers the same."""
    rtol, atol = kernel_tols()
    results, jax_out, _ = tp_world
    scores, jparams, data = jax_out[tag]
    np.testing.assert_allclose(results[0][f"{tag}:scores"], scores,
                               rtol=rtol, atol=atol)
    got = _port_params(results[0], tag)
    assert set(got) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)
    for res in results[1:]:
        for k, v in got.items():
            np.testing.assert_array_equal(_port_params(res, tag)[k], v)
        np.testing.assert_array_equal(res[f"{tag}:out"],
                                      results[0][f"{tag}:out"])


def test_shards_follow_jax_partition_rules(tp_world):
    """Column-parallel dense weights, out-channel conv weights and the
    LSTM's column split; biases and an indivisible head replicated."""
    results, _, _ = tp_world
    shapes = {tag: json.loads(str(results[1][f"{tag}:shapes"]))
              for tag in ("mlp", "lenet", "lstm")}
    assert shapes["mlp"]["0/W"] == [6, 4]
    assert shapes["mlp"]["0/b"] == [16]
    assert shapes["mlp"]["1/W"] == [16, 3]  # 3 classes on model=4
    assert shapes["lenet"]["0/W"] == [10, 1, 5, 5]
    assert shapes["lenet"]["2/W"] == [25, 20, 5, 5]
    assert shapes["lenet"]["4/W"][1] == 16
    assert shapes["lenet"]["5/W"] == [32, 2]
    assert shapes["lstm"]["0/W"][1] * 2 == JNet(lstm_jconf()).init(
    ).params["0"]["W"].shape[1]


def test_save_from_tensor_parallel_world_loads_in_jax(tp_world):
    """The file is a replicated run's: the JAX package restores the
    gathered weights bit for bit; the port's restore re-shards at
    ``data=2 x model=2`` and its next step equals one process's."""
    results, _, run = tp_world
    jnet = jrestore_model(str(run / "mlp_ckpt0.zip"))
    got = _port_params(results[0], "mlp")
    for k, v in _flat(jnet.params).items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    one = restore_model(str(run / "mlp_ckpt0.zip"), device="cpu")
    d = dict(np.load(run / "mlp_data.npz"))
    score = float(one.fit_minibatch(DataSet(d["x"], d["y"])))
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(results[0]["mlp:resumed"], score, rtol=rtol,
                               atol=atol)
    resumed = _port_params(results[0], "mlp", "r")
    for k, v in {f"{ln}/{pn}": p.detach().numpy()
                 for ln, lp in one.params.items()
                 for pn, p in lp.items()}.items():
        np.testing.assert_allclose(resumed[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


def test_unsharded_model_beside_a_sharded_one(tp_world):
    """A model no trainer sharded, in a process that holds a
    tensor-parallel LSTM net, whose LSTM ``W`` has that net's shard
    shape: its forward reads its own weights whole (a layout is its
    model's alone), as in a process of its own."""
    results, _, run = tp_world
    rtol, atol = kernel_tols()
    d = np.load(run / "lstm_data.npz")
    conf = MultiLayerConfiguration.from_json(lstm_jconf(n_out=4).to_json())
    other = MultiLayerNetwork(conf, device="cpu").init()
    assert other.params["0"]["W"].shape[1] == json.loads(
        str(results[0]["lstm:shapes"]))["0/W"][1]
    want = other.output(d["x"], features_mask=d["m"]).numpy()
    for res in results:
        np.testing.assert_allclose(res["other:out"], want, rtol=rtol,
                                   atol=atol)


def test_refusals_and_a_world_of_one():
    """JAX's refusals, and its message where the world does not divide."""
    conf = MultiLayerConfiguration.from_json(mlp_jconf().to_json())
    net = MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="zero=True shards"):
        DistributedTrainer(net, tensor_parallel=True, zero=True)
    with pytest.raises(ValueError, match="batch_stats='local'"):
        DistributedTrainer(net, tensor_parallel=True, batch_stats="local")
    with pytest.raises(ValueError, match="not divisible by model=2"):
        build_mesh(model=2)
    # a model axis of one is replication, as a JAX mesh of model=1
    tr = DistributedTrainer(net, tensor_parallel=True)
    assert not tr.tensor_parallel and tr.mesh.shape == {"data": 1,
                                                        "model": 1}
    # the rules, JAX's, with their silent fall-back
    dense = conf.layers[0]
    assert tensor_parallel.spec_for(dense, "W", (6, 16), 4) == 1
    assert tensor_parallel.spec_for(dense, "b", (16,), 4) is None
    assert tensor_parallel.spec_for(conf.layers[1], "W", (16, 3), 4) is None
    # a layer reads shards only under its own model's layout, which
    # carries the mesh
    w = net.params["0"]
    assert net._tp_layout is None
    assert tensor_parallel.layer_params(None, "0", dense, w) is w
    layout = {"mesh": tr.mesh, "params": {"0": {"W": (1, (6, 4))}}}
    mine = tensor_parallel.layer_params(layout, "0", dense, w)
    assert tensor_parallel.holds_shard(mine) and mine.mesh is tr.mesh
    assert not tensor_parallel.holds_shard(
        tensor_parallel.layer_params(layout, "1", conf.layers[1],
                                     net.params["1"]))
