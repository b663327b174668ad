"""The distributed trainer's row-sharded ``SparseEmbeddingLayer`` branch
(``parallel/trainer.py``, ``parallel/row_exchange.py``) on gloo CPU
ranks, as counterparts of the JAX package's engine tests
(``tests/test_embeddings.py``: sharded rows matching one device, the
eligibility gates and the ``+semb`` kind, the zero and indivisible
fallbacks, the checkpoint round trip).

Each rank is a subprocess of torch + numpy + the port forming a gloo
group through a file under ``tmp_path`` (as ``tests/
test_torch_parallel.py``), under a timeout of its own.

Tolerances: the exchange's forward is the unsharded gather bit for bit
and a checkpoint's trees cross widths bit for bit (the exchange sums
one owned value and ``-0.0``s); training at 2 and 4 ranks matches one
rank and the JAX trainer within ``kernel_tols()`` (f32: rtol 2e-4,
atol 2e-5): the same gradients, summed in another order."""

import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import kernel_tols, require_devices
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import SparseEmbeddingLayer as JSparseEmb
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import DistributedTrainer
from deeplearning4j_tpu_torch.parallel import row_exchange
from deeplearning4j_tpu_torch.util import model_serializer as tser

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 180
V, D, BATCH, STEPS = 64, 8, 32, 4

# One rank of a scenario; argv[1] is a JSON spec.
_CHILD = r"""
import json, sys, warnings
import numpy as np
import torch
from deeplearning4j_tpu_torch.parallel import (
    build_mesh, init_distributed, shutdown_distributed)

spec = json.loads(sys.argv[1])
init_distributed("file://" + spec["rdv"], spec["world"], spec["rank"],
                 device="cpu", timeout_s=120)
mesh = build_mesh(data=spec["world"])
data = dict(np.load(spec["data"]))
out = {}
if spec["scenario"] == "exchange":
    from deeplearning4j_tpu_torch.parallel import row_exchange
    n, r = spec["world"], spec["rank"]
    full = torch.from_numpy(data["table"])
    shard = row_exchange.shard_rows(full, n, r).requires_grad_(True)
    ids = torch.from_numpy(data["ids"][r])
    rows = row_exchange.gather_rows(shard, ids, n, r)
    (rows * torch.from_numpy(data["g"][r])).sum().backward()
    out["rows"] = rows.detach().numpy()
    out["grad"] = shard.grad.numpy()
    out["table"] = row_exchange.gather_table(shard.detach(), n, r).numpy()
else:
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.embeddings.table import gauges
    from deeplearning4j_tpu_torch.nn import core
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import DistributedTrainer
    from deeplearning4j_tpu_torch.util import model_serializer as ser
    conf = MultiLayerConfiguration.from_json(open(spec["corpus"]).read())
    init = {k[2:]: v for k, v in data.items() if k.startswith("p/")}
    net = MultiLayerNetwork(conf, device="cpu").init(
        params=ser.params_from_numpy(init, "cpu") if init else None)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tr = DistributedTrainer(net, mesh=mesh, zero=spec.get("zero", False))
    out["warnings"] = np.asarray(" | ".join(str(w.message) for w in rec))
    if spec.get("telemetry"):
        tr.enable_step_telemetry()
    if spec.get("resume"):
        out["resumed_at"] = np.asarray(tr.resume(spec["resume"]))
    out["w_rows"] = np.asarray(net.params["0"]["W"].shape[0])
    out["m_rows"] = np.asarray([a.shape[0]
                                for a in net.updater_state["0"]["W"]])
    out["gauge"] = np.asarray(gauges()["embedding_shard_bytes"])
    out["kind"] = np.asarray(net._step_kind())
    scores = []
    start = int(net.iteration_count)
    for s in range(spec["steps"]):
        if spec.get("save_at") is not None and s + start == spec["save_at"]:
            ser.write_model(net, spec["save"])
        scores.append(float(tr.fit_minibatch(DataSet(
            data["x"][s + start], data["y"][s + start]))))
    if spec.get("save_at") is not None and spec["steps"] + start == \
            spec["save_at"]:
        ser.write_model(net, spec["save"])
    out["scores"] = np.asarray(scores)
    if spec.get("telemetry"):
        out["grad_norm"] = np.asarray(float(net._last_grad_norm))
    # a sharded table's forward is a collective: every rank, one batch
    out["output"] = net.output(data["x"][0]).numpy()
    params, upd = core.canonical_trees(net)
    for ln, lp in params.items():
        for pn, t in lp.items():
            out[f"p/{ln}/{pn}"] = t.numpy()
            for i, a in enumerate(upd[ln][pn]):
                out[f"u/{ln}/{pn}/{i}"] = a.numpy()
np.savez(spec["out"], **out)
shutdown_distributed()
"""


def run_ranks(tmp_path, world, scenario, arrays, conf=None, **opts):
    """Run ``_CHILD`` on ``world`` gloo ranks; returns each rank's
    results. A run past RANK_TIMEOUT_S kills every rank and fails."""
    run = tmp_path / f"run{len(list(tmp_path.glob('run*')))}"
    run.mkdir()
    np.savez(run / "data.npz", **arrays)
    (run / "conf.json").write_text(conf.to_json() if conf else "{}")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        spec = dict(rank=r, world=world, rdv=str(run / "rdv"),
                    scenario=scenario, data=str(run / "data.npz"),
                    corpus=str(run / "conf.json"),
                    out=str(run / f"out{r}.npz"), **opts)
        if "save" in opts:
            spec["save"] = str(opts["save"]).replace("{rank}", str(r))
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


def zipf_ids(rng, n, v):
    return (rng.zipf(1.3, n) - 1).clip(0, v - 1)


def _jconf(vocab=V, **kw):
    return (JConf.Builder().seed(5).learning_rate(0.05).updater("ADAM")
            .list()
            .layer(JSparseEmb(n_in=vocab, n_out=D, **kw))
            .layer(JDense(n_in=D, n_out=16, activation="tanh"))
            .layer(JOutput(n_in=16, n_out=3))
            .build())


def _data(steps=2 * STEPS, vocab=V, seed=0):
    """Zipf ids (most of a batch on a few rows) and their labels."""
    rng = np.random.RandomState(seed)
    x = zipf_ids(rng, steps * BATCH, vocab).reshape(steps, BATCH, 1)
    y = np.eye(3, dtype=np.float32)[x[..., 0] % 3]
    return x.astype(np.float32), y


def _jax_init(jconf):
    jnet = JNet(jconf).init()
    return jnet, {f"p/{ln}/{pn}": np.asarray(a)
                  for ln, lp in jnet.params.items() for pn, a in lp.items()}


def _port_net(jconf, init):
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    return MultiLayerNetwork(tconf, device="cpu").init(
        params=tser.params_from_numpy({k[2:]: v for k, v in init.items()},
                                      "cpu"))


def _assert_trees(got: dict, want: dict, rtol=None, atol=None):
    keys = [k for k in want if k[:2] in ("p/", "u/")]
    assert keys and set(keys) <= set(got)
    for k in keys:
        if rtol is None:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol, atol,
                                       err_msg=k)


def test_exchange_gathers_and_folds_a_zipf_batch(tmp_path):
    """Two ranks: each rank's rows equal the unsharded gather bit for
    bit, the whole table comes back bit for bit (a ``-0.0`` row
    included), and each shard's gradient is the dense fold of every
    rank's duplicate-heavy occurrences."""
    rng = np.random.RandomState(3)
    table = rng.randn(V, D).astype(np.float32)
    table[5] = -0.0
    ids = zipf_ids(rng, 2 * 48, V).reshape(2, 48)
    assert np.bincount(ids.ravel()).max() > 20   # heavy duplicates
    g = rng.randn(2, 48, D).astype(np.float32)
    res = run_ranks(tmp_path, 2, "exchange",
                    {"table": table, "ids": ids, "g": g})
    dense = np.zeros((V, D), np.float64)
    np.add.at(dense, ids.ravel(), g.reshape(-1, D).astype(np.float64))
    rtol, atol = kernel_tols()
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["rows"], table[ids[r]])
        np.testing.assert_array_equal(out["table"].view(np.int32),
                                      table.view(np.int32))
        np.testing.assert_allclose(out["grad"],
                                   dense[r * V // 2:(r + 1) * V // 2],
                                   rtol, atol)


def test_exchange_at_one_rank_is_the_plain_gather():
    rng = np.random.RandomState(1)
    w = torch.from_numpy(rng.randn(V, D).astype(np.float32))
    w.requires_grad_(True)
    ids = torch.from_numpy(zipf_ids(rng, 40, V))
    rows = row_exchange.gather_rows(w, ids, 1, 0)
    assert torch.equal(rows, w[ids])
    rows.sum().backward()
    want = torch.zeros(V, D).index_add_(0, ids, torch.ones(40, D))
    assert torch.equal(w.grad, want)
    assert row_exchange.world() == (1, 0)


def _match_one_rank_and_jax(tmp_path, world, jconf):
    """``world`` ranks train the Zipf batches with ``W`` and its Adam
    moments sharded 1/N (the gauge says so) and match a world of one and
    JAX's ``DistributedTrainer`` on the same data and weights."""
    require_devices(8)
    from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
    from deeplearning4j_tpu.parallel import DistributedTrainer as JTrainer
    from deeplearning4j_tpu.parallel.mesh import build_mesh as jmesh

    jnet, init = _jax_init(jconf)
    x, y = _data()
    res = run_ranks(tmp_path, world, "train", {"x": x, "y": y, **init},
                    conf=MultiLayerConfiguration.from_json(jconf.to_json()),
                    steps=STEPS)
    one = _port_net(jconf, init)
    tr = DistributedTrainer(one)
    scores = [float(tr.fit_minibatch(DataSet(x[s], y[s])))
              for s in range(STEPS)]
    jt = JTrainer(jnet, mesh=jmesh())
    for s in range(STEPS):
        jt.fit_minibatch(JDataSet(features=x[s], labels=y[s]))
    rtol, atol = kernel_tols()
    want_one = {f"p/{ln}/{pn}": t.numpy() for ln, lp in one.params.items()
                for pn, t in lp.items()}
    want_one.update({f"u/{ln}/{pn}/{i}": a.numpy()
                     for ln, lp in one.updater_state.items()
                     for pn, tup in lp.items() for i, a in enumerate(tup)})
    want_jax = {f"p/{ln}/{pn}": np.asarray(a)
                for ln, lp in jnet.params.items() for pn, a in lp.items()}
    for r, out in enumerate(res):
        assert int(out["w_rows"]) == V // world
        assert list(out["m_rows"]) == [V // world] * 2  # Adam's m and v
        assert int(out["gauge"]) == V // world * D * 4
        assert str(out["kind"]).endswith("+semb")
        assert str(out["warnings"]) == ""
        np.testing.assert_allclose(out["scores"], scores, rtol, atol)
        _assert_trees(out, want_one, rtol, atol)
        _assert_trees(out, want_jax, rtol, atol)
    _assert_trees(res[1], res[0])  # every rank gathers the same trees


@pytest.mark.parametrize("world", [2, 4])
def test_row_sharded_ranks_match_one_rank_and_jax(tmp_path, world):
    _match_one_rank_and_jax(tmp_path, world, _jconf())


def test_sharded_output_and_global_grad_norm_match_one_rank(tmp_path):
    """On two ranks the engine's ``output`` (a collective over the
    sharded table) equals a world of one's, and the step telemetry's
    gradient norm is the global one (the shards' squares summed over the
    ranks)."""
    jconf = _jconf()
    _, init = _jax_init(jconf)
    x, y = _data()
    res = run_ranks(tmp_path, 2, "train", {"x": x, "y": y, **init},
                    conf=MultiLayerConfiguration.from_json(jconf.to_json()),
                    steps=2, telemetry=True)
    one = _port_net(jconf, init)
    tr = DistributedTrainer(one)
    tr.enable_step_telemetry()
    for s in range(2):
        tr.fit_minibatch(DataSet(x[s], y[s]))
    rtol, atol = kernel_tols()
    for out in res:
        assert int(out["w_rows"]) == V // 2
        np.testing.assert_allclose(float(out["grad_norm"]),
                                   float(one._last_grad_norm), rtol, atol)
        np.testing.assert_allclose(out["output"], one.output(x[0]).numpy(),
                                   rtol, atol)


def test_adam_moves_untouched_rows_as_the_dense_step():
    """Adam's moments decay on rows no batch touched (the dense rule
    over the shard, as JAX's GSPMD step): after a step touching row 7
    only, then one touching row 9 only, row 7's parameters still move."""
    jconf = _jconf()
    _, init = _jax_init(jconf)
    net = _port_net(jconf, init)
    tr = DistributedTrainer(net)
    y = np.eye(3, dtype=np.float32)[[1] * 4]
    tr.fit_minibatch(DataSet(np.full((4, 1), 7, np.float32), y))
    before = net.params["0"]["W"][7].clone()
    tr.fit_minibatch(DataSet(np.full((4, 1), 9, np.float32), y))
    assert not torch.equal(net.params["0"]["W"][7], before)


def test_megastep_refused_and_semb_in_the_step_kind():
    """JAX ``test_engine_eligibility_megastep_and_suffix``."""
    net = _port_net(_jconf(), _jax_init(_jconf())[1])
    assert core.has_row_sharded_embedding(net)
    assert "semb" in net._step_kind()
    core.set_transforms(net, megastep=4)
    assert not core.can_megastep(net)
    plain = _port_net(_jconf(row_sharded=False),
                      _jax_init(_jconf(row_sharded=False))[1])
    assert not core.has_row_sharded_embedding(plain)
    assert "semb" not in plain._step_kind()


@pytest.mark.parametrize("case", ["zero", "indivisible"])
def test_fallbacks_replicate_with_the_jax_warning(tmp_path, case):
    """``zero=True`` and a vocabulary the ranks do not divide keep ``W``
    replicated, with the JAX trainer's words, and still train."""
    vocab = V if case == "zero" else V - 1
    jconf = _jconf(vocab=vocab)
    _, init = _jax_init(jconf)
    x, y = _data(vocab=vocab)
    res = run_ranks(tmp_path, 2, "train", {"x": x, "y": y, **init},
                    conf=MultiLayerConfiguration.from_json(jconf.to_json()),
                    steps=2, zero=case == "zero")
    words = "zero=True" if case == "zero" else "not divisible"
    for out in res:
        assert words in str(out["warnings"])
        assert int(out["w_rows"]) == vocab
        assert np.isfinite(out["scores"]).all()


@pytest.mark.parametrize("reg", [
    dict(l2=1e-2, gradient_normalization="ClipL2PerLayer",
         gradient_normalization_threshold=0.05),
    dict(l1=1e-3, gradient_normalization="RenormalizeL2PerParamType"),
    dict(l1=1e-3, l2=1e-2, gradient_normalization="RenormalizeL2PerLayer"),
    dict(l2=1e-2, gradient_normalization="ClipL2PerParamType",
         gradient_normalization_threshold=0.01),
], ids=["l2-clip-layer", "l1-renorm-param", "l1l2-renorm-layer",
        "l2-clip-param"])
def test_penalty_and_norm_normalization_shard(tmp_path, reg):
    """An L1/L2 penalty and a norm-based gradient normalization on the
    layer keep ``W`` sharded, as the JAX trainer does: the shard's
    penalty term and its squares are summed over the ranks, so two ranks
    match one rank and JAX."""
    _match_one_rank_and_jax(tmp_path, 2, _jconf(**reg))


def test_checkpoint_at_width_2_resumes_bitwise_at_widths_1_and_4(tmp_path):
    """A width-2 save gathers the table: the file equals the trees the
    ranks gather, reads back whole into the JAX package, and a resume
    re-shards it at width 1 and at width 4 with every array bit for bit
    (a save right after the resume writes the same file's arrays); the
    continued steps agree across the two widths."""
    from deeplearning4j_tpu.util import model_serializer as jser

    jconf = _jconf()
    _, init = _jax_init(jconf)
    x, y = _data()
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    arrays = {"x": x, "y": y, **init}
    ck2 = tmp_path / "w2_{rank}.zip"
    res2 = run_ranks(tmp_path, 2, "train", arrays, conf=tconf,
                     steps=STEPS, save_at=STEPS, save=ck2)
    files = [tmp_path / f"w2_{r}.zip" for r in range(2)]

    def trees(path):
        m = tser.restore_model(path, device="cpu")
        out = {f"p/{ln}/{pn}": t.numpy() for ln, lp in m.params.items()
               for pn, t in lp.items()}
        out.update({f"u/{ln}/{pn}/{i}": a.numpy()
                    for ln, lp in m.updater_state.items()
                    for pn, tup in lp.items() for i, a in enumerate(tup)})
        return m, out

    m2, saved = trees(files[0])
    assert m2.iteration_count == STEPS
    assert m2.params["0"]["W"].shape[0] == V
    _assert_trees(trees(files[1])[1], saved)
    _assert_trees(res2[0], saved)
    back = jser.restore_multi_layer_network(str(files[0]))
    np.testing.assert_array_equal(np.asarray(back.params["0"]["W"]),
                                  saved["p/0/W"])
    # width 4: resume, save at once, then continue
    res4 = run_ranks(tmp_path, 4, "train", arrays, conf=tconf,
                     steps=0, resume=str(files[0]), save_at=STEPS,
                     save=tmp_path / "w4_{rank}.zip")
    assert int(res4[0]["resumed_at"]) == STEPS
    assert int(res4[0]["w_rows"]) == V // 4
    _assert_trees(trees(tmp_path / "w4_0.zip")[1], saved)
    cont4 = run_ranks(tmp_path, 4, "train", arrays, conf=tconf,
                      steps=STEPS, resume=str(files[0]))
    # width 1: the same resume in this process
    one = MultiLayerNetwork(tconf, device="cpu").init()
    tr = DistributedTrainer(one)
    assert tr.resume(str(files[0])) == STEPS
    tser.write_model(one, tmp_path / "w1.zip")
    _assert_trees(trees(tmp_path / "w1.zip")[1], saved)
    for s in range(STEPS, 2 * STEPS):
        tr.fit_minibatch(DataSet(x[s], y[s]))
    want = {f"p/{ln}/{pn}": t.numpy() for ln, lp in one.params.items()
            for pn, t in lp.items()}
    rtol, atol = kernel_tols()
    _assert_trees(cont4[0], want, rtol, atol)


def test_engine_fit_gathers_a_sharded_model_and_the_trainer_reshards(
        tmp_path):
    """Row-sharded, then the engine's own ``fit`` (whole tables), then
    the trainer again (re-sharded): no step sees a stale layout. At one
    rank the layout is whole throughout."""
    jconf = _jconf()
    _, init = _jax_init(jconf)
    net = _port_net(jconf, init)
    tr = DistributedTrainer(net)
    x, y = _data()
    tr.fit_minibatch(DataSet(x[0], y[0]))
    assert net._row_layout is None
    net.fit_minibatch(DataSet(x[1], y[1]))
    tr.fit_minibatch(DataSet(x[2], y[2]))
    assert net.params["0"]["W"].shape[0] == V
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        DistributedTrainer(net)   # no fallback at one rank
