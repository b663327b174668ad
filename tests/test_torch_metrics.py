"""The port's metrics registry (``observability/metrics.py``) and flight
recorder (``observability/flightrec.py``) against the JAX package's, on
the CPU: the same observations give the same counters, gauges,
histogram buckets and summary quantiles; the runtime's metric families
(the checkpoint manager's, preemption's, the validator's, the guard's,
the prefetch queue's and the dispatch window's) carry JAX's names,
kinds, labels and help strings; the flight recorder keeps, orders and
dumps the same records. Every comparison is exact: both registries do
the same float arithmetic on the same Python floats."""

import json

import numpy as np
import pytest

from deeplearning4j_tpu.observability import flightrec as jflightrec
from deeplearning4j_tpu.observability import metrics as jmetrics
from deeplearning4j_tpu_torch.observability import flightrec, metrics

OBSERVATIONS = [0.05, 3.0, 0.7, 12.5, 250.0, 1e4, 0.7, 41.0, 2.2, 99.9]


def drive(mod):
    """One registry of ``mod`` through the same observations."""
    reg = mod.MetricsRegistry()
    c = reg.counter("requests_total", help="h", labels=("code",))
    g = reg.gauge("depth", help="queue depth")
    h = reg.histogram("wait_ms", buckets=(0.1, 1.0, 10.0, 100.0),
                      help="wait")
    s = reg.summary("stall_ms", reservoir_size=8, help="stall")
    for i, v in enumerate(OBSERVATIONS):
        c.labels("ok" if i % 3 else "err").inc()
        g.set(v)
        h.observe(v)
        s.observe(v)
    return {
        "names": sorted(reg.names()),
        "counters": {k: c.labels(k).value for k in ("ok", "err")},
        "gauge": g.value,
        "hist": h._default().cumulative(),
        "hist_total": (h._default().count, h._default().total),
        "summary": s._default().snapshot(),
        "quantiles": s._default().quantile_values(),
    }


def test_registry_observations_are_jax():
    assert drive(metrics) == drive(jmetrics)


def test_registry_rules_are_jax():
    for mod in (metrics, jmetrics):
        reg = mod.MetricsRegistry()
        reg.counter("x_total")
        with pytest.raises(ValueError):
            reg.gauge("x_total")
        with pytest.raises(ValueError):
            reg.counter("bad name")
        assert reg.counter("x_total") is reg.get("x_total")
        off = mod.MetricsRegistry(enabled=False)
        off.counter("y").inc(5)
        assert off.get("y").value == 0
    r, jr = metrics.Reservoir(4), jmetrics.Reservoir(4)
    for v in OBSERVATIONS:
        r.record(v)
        jr.record(v)
    assert r.snapshot() == jr.snapshot()
    tree = {"a": {"W": np.arange(6.0).reshape(2, 3) - 2.5}}
    assert metrics.mean_magnitudes(tree) == jmetrics.mean_magnitudes(tree)
    assert (json.dumps(metrics.array_histograms(tree, bins=4))
            == json.dumps(jmetrics.array_histograms(tree, bins=4)))


def test_tree_summaries_of_cpu_tensors_are_the_numpy_trees():
    """``mean_magnitudes`` / ``array_histograms`` read a tree of CPU
    tensors (one requiring grad, one bfloat16) exactly as the same tree
    of numpy arrays, and as the JAX package's helpers read it."""
    import torch

    rng = np.random.RandomState(4)
    arrays = {"0": {"W": rng.randn(5, 7).astype(np.float32),
                    "b": rng.randn(7).astype(np.float32)},
              "1": {"W": rng.randn(3, 3).astype(np.float32)}}
    tensors = {"0": {"W": torch.from_numpy(arrays["0"]["W"]).requires_grad_(),
                     "b": torch.from_numpy(arrays["0"]["b"])},
               "1": {"W": torch.from_numpy(arrays["1"]["W"])}}
    assert metrics.mean_magnitudes(tensors) == metrics.mean_magnitudes(
        arrays) == jmetrics.mean_magnitudes(arrays)
    assert (json.dumps(metrics.array_histograms(tensors, bins=5))
            == json.dumps(metrics.array_histograms(arrays, bins=5))
            == json.dumps(jmetrics.array_histograms(arrays, bins=5)))
    before = arrays["1"]["W"].copy()
    host = metrics.host_arrays(tensors, fresh=True)
    tensors["1"]["W"].add_(1.0)  # fresh: the copy does not see it
    np.testing.assert_array_equal(host["1"]["W"], before)
    half = {"h": {"W": torch.from_numpy(arrays["1"]["W"]).bfloat16()}}
    ref = {"h": {"W": half["h"]["W"].float().numpy()}}
    assert metrics.mean_magnitudes(half) == metrics.mean_magnitudes(ref)


def _families(reg, names):
    return {n: (reg.get(n).kind, reg.get(n).help, reg.get(n).label_names,
                tuple(reg.get(n).buckets or ()))
            for n in names if reg.get(n) is not None}


RUNTIME_METRICS = (
    "checkpoint_async_pending", "checkpoint_write_ms",
    "checkpoint_stall_ms", "checkpoint_commit_barrier_ms",
    "checkpoint_scrub_corrupt_total", "checkpoint_repair_total",
    "preemption_notices_total", "preemption_emergency_checkpoints_total",
    "preemption_drain_ms", "training_prefetch_queue_depth",
    "training_prefetch_wait_ms", "training_step_gap_ms",
)


def test_runtime_metric_families_are_jax(tmp_path):
    """Each runtime component of both packages registers into a fresh
    registry of its own package: the same families."""
    from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.api import ListDataSetIterator as JList
    from deeplearning4j_tpu.datasets.prefetch import (
        PrefetchIterator as JPrefetch,
    )
    from deeplearning4j_tpu.parallel import AsyncDispatchWindow as JWindow
    from deeplearning4j_tpu.resilience.checkpoint import (
        CheckpointManager as JManager,
    )
    from deeplearning4j_tpu.resilience.preemption import (
        PreemptionHandler as JHandler,
    )
    from deeplearning4j_tpu_torch.datasets import (
        DataSet,
        ListDataSetIterator,
        PrefetchIterator,
    )
    from deeplearning4j_tpu_torch.parallel import AsyncDispatchWindow
    from deeplearning4j_tpu_torch.resilience import (
        CheckpointManager,
        PreemptionHandler,
    )

    got = []
    for mod, manager, handler, prefetch, window, ds, lst in (
            (metrics, CheckpointManager, PreemptionHandler, PrefetchIterator,
             AsyncDispatchWindow, DataSet, ListDataSetIterator),
            (jmetrics, JManager, JHandler, JPrefetch, JWindow, JDataSet,
             JList)):
        reg = mod.MetricsRegistry()
        manager(tmp_path / mod.__name__, registry=reg)
        handler(registry=reg)
        it = prefetch(lst([ds(np.zeros((1, 2)), np.zeros((1, 2)))]),
                      registry=reg)
        list(it)
        it.shutdown()
        window(registry=reg)
        got.append(_families(reg, RUNTIME_METRICS))
    assert got[0] == got[1] and set(got[0]) == set(RUNTIME_METRICS)


def test_default_registry_families_of_the_validator_and_guard_are_jax():
    from deeplearning4j_tpu.datasets import validate as jvalidate
    from deeplearning4j_tpu.resilience import guard as jguard
    from deeplearning4j_tpu_torch.datasets import validate
    from deeplearning4j_tpu_torch.resilience import guard

    names = ("batches_quarantined_total", "quarantine_bytes",
             "guard_spike_trips_total", "guard_loss_ewma",
             "guard_gradnorm_ewma")
    validate._quarantine_metrics()
    guard._guard_metrics()
    jvalidate._quarantine_metrics()
    jguard._guard_metrics()
    mine = _families(metrics.default_registry(), names)
    assert mine == _families(jmetrics.default_registry(), names)
    assert set(mine) == set(names)


def _strip(records):
    return [{k: v for k, v in r.items() if k not in ("t", "pid")}
            for r in records]


def test_flight_recorder_is_jax(tmp_path):
    """The same records and events into both recorders (a ring of 4):
    the same retained tail, last step and dump lines (timestamps and the
    process id aside); the global recorder's None-safe hooks."""
    recs = []
    for mod, d in ((flightrec, tmp_path / "p"), (jflightrec, tmp_path / "j")):
        rec = mod.FlightRecorder(capacity=4, dump_dir=str(d),
                                 clock=lambda: 123.0)
        for step in range(1, 4):
            rec.record(step=step, loss=1.0 / step, grad_norm=float("inf"))
        rec.event("guard_trip", step=2, policy="skip")
        rec.event("checkpoint_commit", step=3, ms=np.float32(1.5))
        path = rec.dump(reason="test")
        lines = [json.loads(x) for x in open(path).read().splitlines()]
        recs.append((_strip(rec.tail()), rec.last_step(), _strip(lines)))
        prev = mod.set_flight_recorder(rec)
        mod.record_event("quarantine", offset=7)
        assert rec.tail(1)[0]["event"] == "quarantine"
        mod.set_flight_recorder(prev)
        mod.record_event("ignored")  # no recorder: a no-op
    assert recs[0] == recs[1]
    assert recs[0][1] == 3 and len(recs[0][0]) == 4
