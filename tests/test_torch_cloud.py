"""The port's object-store datasets and provisioning plan
(``deeplearning4j_tpu_torch/cloud``) against the JAX package's, on the
CPU: shards either package writes read back equal in the other (the
minibatch npz codec), ``CloudDataSetIterator`` feeds a fit bitwise the
same fit from a list, and the provisioning plan is the JAX package's
line for line."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import cloud as jcloud
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu_torch import cloud
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.resilience.store import RetryingObjectStore
from deeplearning4j_tpu_torch.zoo import lenet


def _batches(n, batch=8, seed=2, masks=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.rand(batch, 784).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, batch)]
        lm = (rng.rand(batch) > 0.3).astype(np.float32) if masks else None
        out.append((x, y, lm))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shards_written_by_one_package_read_in_the_other(tmp_path, writer):
    raw = _batches(3, masks=True)
    if writer == "jax":
        keys = jcloud.save_dataset_shards(
            [JDataSet(x, y, labels_mask=m) for x, y, m in raw],
            jcloud.LocalObjectStore(tmp_path / "bucket"))
        it = cloud.CloudDataSetIterator(
            cloud.LocalObjectStore(tmp_path / "bucket"))
    else:
        keys = cloud.save_dataset_shards(
            [DataSet(x, y, labels_mask=m) for x, y, m in raw],
            cloud.LocalObjectStore(tmp_path / "bucket"))
        it = jcloud.CloudDataSetIterator(
            jcloud.LocalObjectStore(tmp_path / "bucket"))
    assert keys == [f"dataset/shard-{i:06d}.npz" for i in range(3)]
    assert it.batch() == 8
    got = list(it)
    assert len(got) == 3
    for ds, (x, y, m) in zip(got, raw):
        np.testing.assert_array_equal(ds.features, x)
        np.testing.assert_array_equal(ds.labels, y)
        np.testing.assert_array_equal(ds.labels_mask, m)
        assert ds.features_mask is None


def test_cloud_iterator_feeds_fit_bitwise_a_list_fit(tmp_path):
    batches = [DataSet(x, y) for x, y, _ in _batches(5)]
    ref = MultiLayerNetwork(lenet(), device="cpu").init()
    init = {ln: {pn: t.clone() for pn, t in lp.items()}
            for ln, lp in ref.params.items()}
    ref.fit(ListDataSetIterator(batches), epochs=2)
    store = cloud.LocalObjectStore(tmp_path / "bucket")
    cloud.save_dataset_shards(batches, store, prefix="mnist/")
    it = cloud.CloudDataSetIterator(store, prefix="mnist/", retry=True)
    assert isinstance(it.store, RetryingObjectStore)
    net = MultiLayerNetwork(lenet(), device="cpu").init(params=init)
    net.fit(it, epochs=2)
    assert net.iteration_count == ref.iteration_count == 10
    for ln, lp in ref.params.items():
        for pn, t in lp.items():
            assert torch.equal(net.params[ln][pn], t), (ln, pn)
    with pytest.raises(ValueError, match="no dataset shards"):
        cloud.CloudDataSetIterator(store, prefix="missing/")


def test_cloud_exports_the_retrying_store():
    assert cloud.RetryingObjectStore is RetryingObjectStore
    assert hasattr(jcloud, "RetryingObjectStore")


@pytest.mark.parametrize("kw", [
    dict(name="trainer", accelerator_type="v5litepod-16", zone="us-east5-b",
         project="proj"),
    dict(name="pod", accelerator_type="v4-32", preemptible=True),
    dict(name="one", accelerator_type="v5litepod-1",
         runtime_version="v2-alpha-tpuv5-lite"),
])
def test_provisioning_plan_equals_jax(kw):
    p, j = cloud.TpuPodProvisioner(**kw), jcloud.TpuPodProvisioner(**kw)
    assert p.create_plan() == j.create_plan()
    assert p.delete_plan() == j.delete_plan()
    assert p.ssh_plan("echo 'a b'", worker="1") == j.ssh_plan(
        "echo 'a b'", worker="1")
    assert p.num_hosts() == j.num_hosts()
    assert p.worker_env("10.0.0.2", 9000) == j.worker_env("10.0.0.2", 9000)
    setup = ["pip install -e .", "git pull"]
    cs = cloud.ClusterSetup(p, setup_commands=setup,
                            train_command="python train.py")
    jcs = jcloud.ClusterSetup(j, setup_commands=setup,
                              train_command="python train.py")
    assert cs.plan() == jcs.plan()
    assert cs.plan("10.0.0.9", 1234) == jcs.plan("10.0.0.9", 1234)
    ran, jran = [], []
    assert cs.exec("h", runner=ran.append) == jcs.exec("h",
                                                       runner=jran.append)
    assert ran == jran
    created, jcreated = [], []
    assert p.create(runner=created.append) == j.create(
        runner=jcreated.append)
    assert created == jcreated and p.created == j.created


def test_host_provisioner_and_unknown_slices_match_jax():
    h, jh = cloud.HostProvisioner("w0"), jcloud.HostProvisioner("w0")
    for c in ("echo hello", ["ls", "-l"]):
        assert h.run(c) is None and jh.run(c) is None
    assert h.commands_run == jh.commands_run
    with pytest.raises(ValueError, match="unknown accelerator"):
        cloud.TpuPodProvisioner(name="x", accelerator_type="v99").num_hosts()
