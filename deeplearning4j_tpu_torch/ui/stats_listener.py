"""StatsListener (reference ``ui/stats/StatsListener.java:46``,
``iterationDone:259``): per-iteration score, param/update stats,
memory (``:310``), learning rates — routed to a StatsStorage.

Counterpart of ``deeplearning4j_tpu/ui/stats_listener.py``. Param
stats read the model's tensors back from the card, so collection is
gated by ``frequency`` (collect every Nth iteration) and histograms by
``collect_histograms``, mirroring the reference's
``StatsUpdateConfiguration`` knobs. A sampled report reads the
parameter tree back once (``observability.metrics.host_arrays``: one
non-blocking copy a tensor, one wait) and computes the magnitudes,
the update deltas and the histograms from that host copy. The listener
takes no chunk's callbacks after it (no ``supports_batched_iterations``),
so the engines run it on the per-step loop; on the megastep path it
reports once a chunk (``chunk_done``)."""

from __future__ import annotations

import json
import os
import resource
import time
import uuid
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import __version__
from deeplearning4j_tpu_torch.observability.metrics import (
    MetricsRegistry,
    array_histograms,
    default_registry,
    host_arrays,
    mean_magnitudes,
)
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.ui.model import (
    StatsInitializationReport,
    StatsReport,
    StatsStorage,
    now_ms,
)


def _graph_structure_json(model) -> str:
    """Nodes + edges for the model-graph page (reference
    ``FlowListenerModule``/``TrainModule`` model tab): a chain for
    MultiLayerNetwork, vertex_inputs for ComputationGraph."""
    try:
        conf = model.conf
        if hasattr(conf, "vertex_inputs"):  # ComputationGraph
            nodes = (
                [{"name": n, "type": "input"} for n in conf.inputs]
                + [
                    {
                        "name": n,
                        "type": type(
                            getattr(v, "layer_conf", None) or v
                        ).__name__,
                    }
                    for n, v in conf.vertices.items()
                ]
            )
            edges = [
                {"from": src, "to": name}
                for name, srcs in conf.vertex_inputs.items()
                for src in srcs
            ]
        else:  # MultiLayerNetwork chain
            names = list(getattr(model, "layer_names", []))
            nodes = [{"name": "input", "type": "input"}] + [
                {"name": n, "type": type(l).__name__}
                for n, l in zip(names, conf.layers)
            ]
            chain = ["input"] + names
            edges = [
                {"from": a, "to": b} for a, b in zip(chain, chain[1:])
            ]
        return json.dumps({"nodes": nodes, "edges": edges})
    except Exception:
        return "{}"


def hardware_info(device) -> dict:
    """The cards' count and names where ``device`` is a card, else one
    ``"cpu"`` (the init report's ``hardware``)."""
    device = torch.device(device)
    if device.type == "cuda":
        n = torch.cuda.device_count()
        return {"backend": "cuda", "device_count": str(n),
                "devices": ",".join(torch.cuda.get_device_name(i)
                                    for i in range(n))}
    return {"backend": device.type, "device_count": "1",
            "devices": device.type}


class StatsListener(IterationListener):
    """Collects and routes training statistics (reference
    ``StatsListener.java``)."""

    def __init__(self, storage: StatsStorage, frequency: int = 1,
                 collect_histograms: bool = False,
                 session_id: Optional[str] = None,
                 worker_id: str = "worker-0",
                 registry: Optional[MetricsRegistry] = None,
                 collect_param_stats: bool = True,
                 defer_score_read: bool = True):
        """``collect_param_stats=False`` drops the per-sample param
        reads (mean magnitudes, update deltas, histograms) — those
        reads wait for the sampled step to finish on the card; without
        them (and with ``defer_score_read``, which publishes the sampled
        score one sampled callback LATE, when its step has already
        finished) the listener forces no per-step device sync at all."""
        self.storage = storage
        self.frequency = max(int(frequency), 1)
        self.collect_histograms = collect_histograms
        self.collect_param_stats = collect_param_stats
        self.defer_score_read = defer_score_read
        self._pending_report = None  # (StatsReport, score_ref)
        self.session_id = session_id or uuid.uuid4().hex[:12]
        self.worker_id = worker_id
        # shared metrics substrate: the same signals the StatsReport
        # records also land in the registry the UI server exports at
        # /metrics?format=prometheus
        self.registry = (
            registry if registry is not None else default_registry()
        )
        self._score_gauge = self.registry.gauge(
            "training_score", help="latest sampled minibatch score"
        )
        self._iter_gauge = self.registry.gauge(
            "training_iteration", help="latest sampled iteration"
        )
        self._rss_gauge = self.registry.gauge(
            "training_host_rss_mb", help="host max RSS (MB)"
        )
        self._init_sent = False
        self._last_time: Optional[float] = None
        self._prev_params: Optional[dict] = None

    def _send_init(self, model) -> None:
        n_params = sum(
            int(a.numel()) if torch.is_tensor(a) else int(np.size(a))
            for lp in model.params.values() for a in lp.values()
        )
        rec = StatsInitializationReport(
            session_id=self.session_id, worker_id=self.worker_id,
            timestamp=now_ms(),
            software={"framework": "deeplearning4j_tpu_torch",
                      "version": __version__, "torch": torch.__version__,
                      "cuda": str(torch.version.cuda)},
            hardware=hardware_info(getattr(model, "device", "cpu")),
            model={
                "class": type(model).__name__,
                "layers": ",".join(getattr(model, "layer_names", [])),
                "n_params": str(n_params),
                "graph_json": _graph_structure_json(model),
            },
        )
        self.storage.put_static_info(rec)
        self._init_sent = True

    def iteration_done(self, model, iteration: int) -> None:
        if not self._init_sent:
            self._send_init(model)
        if iteration % self.frequency != 0:
            return
        now = time.perf_counter()
        duration_ms = (
            (now - self._last_time) * 1000.0 / self.frequency
            if self._last_time is not None else 0.0
        )
        self._last_time = now
        rec = self._build_report(model, iteration, duration_ms)
        score_ref = getattr(model, "_last_score", None)
        if self.defer_score_read:
            # publish the PREVIOUS sampled report now (its score was
            # computed long ago — reading it waits for nothing), park
            # this one until the next sample or flush()/on_epoch_end
            pending = self._pending_report
            self._pending_report = (rec, score_ref)
            if pending is not None:
                self._publish(*pending)
        else:
            self._publish(rec, score_ref)

    def chunk_done(self, model, it0: int, k: int, metrics) -> None:
        """Megastep cadence: at most ONE report per fused K-step
        chunk (when a sampling boundary falls inside it). The chunk's
        scores arrive already host-side from the driver's single
        readback, so the report publishes immediately — no deferred
        score read, no extra device sync; the blocking param-stat
        reads stay gated by ``collect_param_stats`` as per-step."""
        if not self._init_sent:
            self._send_init(model)
        if (it0 + k) // self.frequency == it0 // self.frequency:
            return  # no sampling boundary inside this chunk
        now = time.perf_counter()
        duration_ms = (
            (now - self._last_time) * 1000.0 / k
            if self._last_time is not None else 0.0
        )
        self._last_time = now
        rec = self._build_report(model, it0 + k, duration_ms)
        scores = metrics.get("scores") if hasattr(metrics, "get") \
            else None
        score = (
            float(scores[-1])
            if scores is not None and len(scores) else float("nan")
        )
        self._publish(rec, score)

    def _build_report(self, model, iteration: int,
                      duration_ms: float) -> "StatsReport":
        lrs = {}
        for i, layer in enumerate(getattr(model.conf, "layers", [])):
            lrs[getattr(layer, "name", "") or str(i)] = float(
                getattr(layer, "learning_rate", 0.0)
            )
        update_mags = {}
        param_mags = {}
        histograms = {}
        if self.collect_param_stats:
            # one read of the tree back to the host, waiting for the
            # sampled step: the price of param introspection. Fresh
            # copies: a captured chunk writes the same tensors in place
            params = host_arrays(model.params, fresh=True)
            if self._prev_params is not None:
                for lname, lp in params.items():
                    for pname, arr in lp.items():
                        prev = self._prev_params[lname][pname]
                        update_mags[f"{lname}_{pname}"] = float(
                            np.mean(np.abs(arr - prev))
                        )
            self._prev_params = params
            param_mags = mean_magnitudes(params)
            if self.collect_histograms:
                histograms = array_histograms(params)
        maxrss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        self._iter_gauge.set(iteration)
        self._rss_gauge.set(maxrss_kb / 1024.0)
        rec = StatsReport(
            session_id=self.session_id, worker_id=self.worker_id,
            timestamp=now_ms(), iteration=iteration,
            score=float("nan"),  # filled at publish time
            duration_ms=duration_ms,
            memory={
                "host_rss_mb": maxrss_kb / 1024.0,
                "pid": float(os.getpid()),
            },
            learning_rates=lrs,
            param_mean_magnitudes=param_mags,
            update_mean_magnitudes=update_mags,
            param_histograms=histograms,
        )
        return rec

    def _publish(self, rec, score_ref) -> None:
        try:
            score = float(score_ref)
        except Exception:
            score = float("nan")
        rec.score = score
        self._score_gauge.set(score)
        self.storage.put_update(rec)

    def flush(self) -> None:
        """Publish the pending deferred report (epoch end / end of
        fit)."""
        pending, self._pending_report = self._pending_report, None
        if pending is not None:
            self._publish(*pending)

    def on_epoch_end(self, model) -> None:
        self.flush()


class J7StatsListener(StatsListener):
    """Compatibility alias (reference ``J7StatsListener`` — a Java-7
    safe variant; no behavioral difference here)."""
