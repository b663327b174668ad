"""Step profiling: a FLOP / byte cost model per step shape, and each
step's wall time split into its parts.

Counterpart of ``deeplearning4j_tpu/observability/profiler.py``, in two
halves:

**CostModel**: an immutable (FLOPs, bytes, arithmetic intensity) record
keyed by the step's kind, transform suffix, input shape and dtype
(``step_cost_key``). The JAX package reads XLA's ``cost_analysis()`` of
the compiled step; the port has no compiler to ask, and its kernels are
launched through ``ctypes``, where ``torch.utils.flop_counter`` cannot
see them. So ``train_step_cost`` runs one step of the *plain* path (the
kernels' plain PyTorch versions: ``F.conv2d``, ``F.unfold``,
``torch.matmul``, the same math) on ``meta`` tensors at the real shapes
under ``FlopCounterMode`` (``ops.dispatch.plain_on_meta``): no data, no
card time. Its bytes follow one stated rule (``step_bytes``): each
parameter, gradient, updater-state leaf and layer activation is read
once and written once, and each input array read once. Against a measured step time it gives ``step_mfu``,
``step_flops_per_sec``, ``step_bytes_per_sec`` and a roofline class.

**StepProfiler**: each step's wall time split over the existing seams:

- ``input_stall_ms``: the ``PrefetchIterator`` consumer's wait;
- ``dispatch_ms``: the ``AsyncDispatchWindow``'s block (back-pressure);
- ``device_ms``: on the card, the time between two CUDA events recorded
  on the step's stream at ``begin_step`` and ``end_step``, read when the
  step retires (``end_step`` waits for the second event; the JAX
  package blocks until the step's arrays are ready instead); on the CPU
  what the seams note;
- ``host_ms``: the rest (Python bookkeeping and listener callbacks, the
  listeners' share also in each record as ``listener_ms``).

The four parts sum to the measured wall time by construction (host is
the remainder, clamped at 0 where a part measured on another thread
overlaps). They are exported as histograms and traced as children of a
``train.step`` span. A scan or megastep chunk is one record covering
its k steps.

**Roofline class** (gauge ``step_roofline_class``): ``input_bound`` (3)
when the input stall exceeds ``input_bound_frac`` (25 %) of the wall;
else ``compute_bound`` (1) when the step's arithmetic intensity is at
or above the machine balance (peak FLOP/s over peak bytes/s),
``memory_bound`` (2) below it; ``unknown`` (0) without a peak.

**Peaks** come from a table keyed by the card's name (``_PEAKS``: the
H100 SXM's 67 TFLOP/s f32, 989 TFLOP/s bf16 / f16 dense and 3.35 TB/s)
or from the caller (``StepProfiler(peak=..., peak_bw=...)``); none on
the CPU.

Install with ``set_active_profiler(StepProfiler(...))``: the engines'
fit paths, the prefetch iterator and the dispatch window read the
process-global at one attribute read and a None check a touchpoint.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

# (card-name substring, peak FLOP/s by compute dtype, peak bytes/s):
# the first hit wins. Dense tensor-core rates for the half types.
_PEAKS: Tuple[Tuple[str, Dict[str, float], float], ...] = (
    ("h100 pcie", {"float32": 51e12, "bfloat16": 756e12,
                   "float16": 756e12}, 2.0e12),
    ("h100", {"float32": 67e12, "bfloat16": 989e12,
              "float16": 989e12}, 3.35e12),
)

ROOFLINE_UNKNOWN = 0
ROOFLINE_COMPUTE = 1
ROOFLINE_MEMORY = 2
ROOFLINE_INPUT = 3
ROOFLINE_NAMES = {
    ROOFLINE_UNKNOWN: "unknown",
    ROOFLINE_COMPUTE: "compute_bound",
    ROOFLINE_MEMORY: "memory_bound",
    ROOFLINE_INPUT: "input_bound",
}


def _card_name(device=None) -> Optional[str]:
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(device)


def _table_row(name: Optional[str]):
    if name is None:
        return None
    low = name.lower()
    for key, flops, bw in _PEAKS:
        if key in low:
            return flops, bw
    return None


def peak_flops(device=None, dtype: str = "float32"
               ) -> Tuple[Optional[float], str]:
    """(peak FLOP/s for ``dtype``, source): the table's figure for the
    card's name, else None (the CPU, or a card the table lacks)."""
    name = _card_name(device)
    row = _table_row(name)
    if row is None:
        return None, name or "cpu"
    return row[0].get(str(dtype), row[0]["float32"]), name


def peak_bytes_per_sec(device=None) -> Tuple[Optional[float], str]:
    """(peak memory bytes/s, source): the table's figure for the card's
    name, else None."""
    name = _card_name(device)
    row = _table_row(name)
    if row is None:
        return None, name or "cpu"
    return row[1], name


# -- cost model ---------------------------------------------------------


@dataclass(frozen=True)
class CostModel:
    """The work of one step: FLOPs and bytes, keyed by its identity."""

    key: str
    flops: float
    bytes_accessed: float

    @property
    def arithmetic_intensity(self) -> float:
        """FLOPs per byte: the x-axis of the roofline."""
        return (self.flops / self.bytes_accessed
                if self.bytes_accessed else 0.0)

    def achieved(self, wall_s: float, peak: Optional[float] = None) -> dict:
        """Rates of one execution taking ``wall_s`` seconds:
        ``flops_per_sec``, ``bytes_per_sec`` and ``mfu`` against ``peak``
        (None without one)."""
        fps = self.flops / wall_s if wall_s > 0 else 0.0
        bps = self.bytes_accessed / wall_s if wall_s > 0 else 0.0
        return {"flops_per_sec": fps, "bytes_per_sec": bps,
                "mfu": (fps / peak) if peak else None}

    def roofline_class(self, peak: Optional[float],
                       peak_bw: Optional[float]) -> int:
        """Compute- or memory-bound by the arithmetic intensity against
        the machine balance; unknown without both peaks."""
        if not peak or not peak_bw or not self.bytes_accessed:
            return ROOFLINE_UNKNOWN
        return (ROOFLINE_COMPUTE
                if self.arithmetic_intensity >= peak / peak_bw
                else ROOFLINE_MEMORY)

    @classmethod
    def from_cost_dict(cls, key: str, cost: dict) -> "CostModel":
        return cls(key=key, flops=float(cost.get("flops", 0.0)),
                   bytes_accessed=float(cost.get(
                       "bytes_accessed", cost.get("bytes accessed", 0.0))))


def _shape_tag(shape) -> str:
    shape = tuple(shape)
    if shape and isinstance(shape[0], (tuple, list)):
        return ";".join("x".join(str(int(d)) for d in s) for s in shape)
    return "x".join(str(int(d)) for d in shape)


def transform_kind_suffix(model) -> str:
    """The step's flavour as a key suffix (JAX
    ``transform_kind_suffix``'s parts that the port has): remat, loss
    scaling, the statistical guard, gradient accumulation, megastep and
    ZeRO's layout, and ``+semb`` for a row-sharded embedding table (an
    artifact traced with the table sharded is refused by a replicated
    model, and the other way round)."""
    from deeplearning4j_tpu_torch.nn import core

    parts = []
    if getattr(model, "scan_layers", False):
        parts.append("scan")
    if getattr(model, "remat", "none") != "none":
        parts.append(f"remat:{model.remat}")
    if core.loss_scale_active(model):
        parts.append("lossscale")
    if core.stat_guard_config(model) is not None:
        parts.append("statguard")
    if int(getattr(model, "grad_accum", 1)) > 1:
        parts.append(f"accum:{model.grad_accum}")
    if core.megastep_active(model):
        parts.append(f"mega:{model.megastep}")
    if getattr(model, "_zero_layout", None):
        parts.append("zero")
    if core.has_row_sharded_embedding(model):
        parts.append("semb")
    return "".join("+" + p for p in parts)


def step_cost_key(model, batch_shape, dtype) -> str:
    """Identity of a train step's cost: kind, transform suffix, input
    shape and dtype (JAX ``step_cost_key``)."""
    return (f"step{transform_kind_suffix(model)}"
            f":{_shape_tag(batch_shape)}:{dtype}")


def output_cost_key(model, batch_shape, dtype) -> str:
    """Identity of an inference forward's cost (a serving bucket)."""
    return f"output:{_shape_tag(batch_shape)}:{dtype}"


def kernel_cost_key(kernel: str, identity: dict, config=None) -> str:
    """Identity of one kernel variant's cost: the kernel, its shape and
    dtype identity, and the tile configuration where one is meant."""
    tag = ";".join(f"{k}={identity[k]}" for k in sorted(identity))
    key = f"kernel:{kernel}:{tag}"
    if config is not None:
        key += ":cfg=" + "x".join(str(int(v)) for v in config)
    return key


class CostModelCache:
    """Cost models computed once per key. A build that fails is cached
    as None: a model that cannot be counted costs one attempt."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models: Dict[str, Optional[CostModel]] = {}

    def get_or_build(self, key: str,
                     builder: Callable[[], Optional[CostModel]]
                     ) -> Optional[CostModel]:
        with self._lock:
            if key in self._models:
                return self._models[key]
        try:
            cm = builder()
        except Exception:
            cm = None
        with self._lock:
            self._models.setdefault(key, cm)
            return self._models[key]

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: ({"flops": v.flops,
                         "bytes_accessed": v.bytes_accessed,
                         "arithmetic_intensity":
                             round(v.arithmetic_intensity, 3)}
                        if v is not None else None)
                    for k, v in self._models.items()}


def _meta(tree):
    import torch

    from deeplearning4j_tpu_torch.nn.core import _map_tree

    return _map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                           device="meta"), tree)


def _tree_bytes(tree) -> int:
    from deeplearning4j_tpu_torch.nn.core import _leaves, nbytes

    return sum(nbytes(t) for t in _leaves(tree))


def _meta_batch(model, ds):
    """The step's inputs of ``ds`` as meta tensors at their shapes."""
    return model.batch_tensors(ds, device="meta")


def step_bytes(model, ds) -> float:
    """Bytes one train step moves by the stated rule: each parameter,
    gradient (the parameter's size) and updater-state leaf read once
    and written once, each layer's (vertex's) activation written once in
    the forward and read once in the backward, each input array read
    once. The activations come from a forward on meta tensors."""
    import torch

    from deeplearning4j_tpu_torch.nn import core

    from deeplearning4j_tpu_torch.ops import dispatch

    params = _meta(model.params)
    state = _meta(model.state)
    x, y, lmask, fmask = _meta_batch(model, ds)
    with torch.no_grad(), dispatch.plain_on_meta():
        if hasattr(model.conf, "vertices"):
            values, _, _ = model._forward_values(params, state, x,
                                                 train=True, fmasks=fmask)
            acts = [v for n, v in values.items()
                    if n not in model.conf.inputs]
        else:
            acts, _ = core.sequential_forward(
                model.conf, model.layer_names, params, state, x, train=True,
                fmask=fmask, collect=True)
    p = _tree_bytes(model.params)
    u = _tree_bytes(model.updater_state)
    a = _tree_bytes(acts)
    inputs = _tree_bytes([x, y, lmask, fmask])
    return float(2 * p + 2 * p + 2 * u + 2 * a + inputs)


def train_step_cost(model, ds) -> dict:
    """The FLOPs of one train step of ``model`` on ``ds`` (forward, loss,
    backward and updater of the bare flavour: the program a scan chunk
    runs k times), counted by ``FlopCounterMode`` over the plain path on
    meta tensors at the real shapes, and its bytes by ``step_bytes``:
    ``{"flops", "bytes_accessed", "batch", "flops_per_example"}``."""
    from torch.utils.flop_counter import FlopCounterMode

    from deeplearning4j_tpu_torch.nn import core
    from deeplearning4j_tpu_torch.ops import dispatch

    if model.params is None:
        model.init()
    step = core.build_step(model._score_fn(), model.updater_def,
                           model.grad_accum, model.recurrent_names())
    params = _meta(model.params)
    upd = _meta(model.updater_state)
    state = _meta(model.state)
    x, y, lmask, fmask = _meta_batch(model, ds)
    lrs = model.updater_def.scheduled_lrs(0)
    counter = FlopCounterMode(display=False)
    with counter, dispatch.plain_on_meta():
        step(params, upd, state, x, y, lmask, lrs, 1, fmask,
             rng=core.step_rng(model, 0))
    flops = float(counter.get_total_flops())
    first = x[0] if isinstance(x, (list, tuple)) else x
    batch = int(first.shape[0])
    return {"flops": flops, "bytes_accessed": step_bytes(model, ds),
            "batch": batch, "flops_per_example": flops / max(batch, 1)}


def _features_identity(ds):
    import numpy as np

    feats = ds.features
    if isinstance(feats, (list, tuple)):
        present = [f for f in feats if f is not None]
        return (tuple(tuple(np.shape(f)) for f in present),
                str(present[0].dtype))
    return tuple(np.shape(feats)), str(feats.dtype)


def train_step_cost_model(model, ds) -> Optional[CostModel]:
    """The ``CostModel`` of ``model``'s train step on minibatch ``ds``,
    keyed by ``step_cost_key``."""
    shape, dtype = _features_identity(ds)
    return CostModel.from_cost_dict(step_cost_key(model, shape, dtype),
                                    train_step_cost(model, ds))


def output_cost_model(model, batch_shape,
                      dtype="float32") -> Optional[CostModel]:
    """The ``CostModel`` of the model's inference forward (either engine;
    a graph's first input and output) at one padded bucket shape (a
    serving warm-up): ``FlopCounterMode`` over the plain forward on meta
    tensors; bytes: the parameters and the input read
    once, the output written once."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from deeplearning4j_tpu_torch.nn import core
    from deeplearning4j_tpu_torch.ops import dispatch

    if getattr(model, "params", None) is None:
        return None
    x = torch.empty(tuple(int(d) for d in batch_shape),
                    dtype=core.torch_dtype(dtype), device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad(), dispatch.plain_on_meta():
        if hasattr(model, "layer_vertex_names"):  # a ComputationGraph
            values, _, _ = model._forward_values(
                _meta(model.params), _meta(model.state), [x], train=False)
            y = values[model.conf.outputs[0]]
        else:
            y, _ = core.sequential_forward(model.conf, model.layer_names,
                                           _meta(model.params),
                                           _meta(model.state), x)
    return CostModel(output_cost_key(model, batch_shape, dtype),
                     float(counter.get_total_flops()),
                     float(_tree_bytes(model.params) + core.nbytes(x)
                           + core.nbytes(y)))


# -- step profiler ------------------------------------------------------

DECOMP_MS_BUCKETS = (0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                     100.0, 250.0, 1000.0)


class _StepState:
    __slots__ = ("step", "t0", "input_ms", "dispatch_ms", "device_ms",
                 "listener_ms", "span", "start")

    def __init__(self, step, t0, span, start=None):
        self.step = step
        self.t0 = t0
        self.input_ms = 0.0
        self.dispatch_ms = 0.0
        self.device_ms = 0.0
        self.listener_ms = 0.0
        self.span = span
        self.start = start  # the CUDA event at begin_step, or None


def _as_number(v):
    """A record's value: a tensor read as a float (the step has
    retired), anything else as it is."""
    import torch

    if torch.is_tensor(v):
        return float(v)
    return v


class StepProfiler:
    """Each step's cost-model rates and wall-time split (see the module
    docstring). One instance a training run; install process-globally
    with ``set_active_profiler``. ``peak`` / ``peak_bw`` default to the
    table's figures for the card, the FLOP rate of the model's compute
    dtype (f32 where a record names no model)."""

    def __init__(self, registry=None, tracer=None, recorder=None,
                 enabled: bool = True, peak: Optional[float] = None,
                 peak_bw: Optional[float] = None,
                 input_bound_frac: float = 0.25,
                 clock: Callable[[], float] = time.perf_counter):
        from deeplearning4j_tpu_torch.observability.metrics import (
            default_registry,
        )
        from deeplearning4j_tpu_torch.observability.trace import get_tracer

        self.enabled = enabled
        self.registry = (registry if registry is not None
                         else default_registry())
        self.tracer = tracer if tracer is not None else get_tracer()
        self.recorder = recorder
        self.costs = CostModelCache()
        self.input_bound_frac = float(input_bound_frac)
        self._clock = clock
        self._peak_given = peak is not None
        if peak is None:
            peak, self.peak_source = peak_flops()
        else:
            self.peak_source = "caller"
        if peak_bw is None:
            peak_bw, self.peak_bw_source = peak_bytes_per_sec()
        else:
            self.peak_bw_source = "caller"
        self.peak = peak
        self.peak_bw = peak_bw
        self._state: Optional[_StepState] = None
        self._cost_memo = None  # (sig, CostModel)
        reg = self.registry
        self._h_input = reg.histogram(
            "training_input_stall_ms", buckets=DECOMP_MS_BUCKETS,
            help="step decomposition: fit loop starved for the next "
                 "batch (prefetch consumer wait)",
        )._default()
        self._h_host = reg.histogram(
            "training_host_ms", buckets=DECOMP_MS_BUCKETS,
            help="step decomposition: host-side remainder — Python "
                 "bookkeeping + listener callbacks",
        )._default()
        self._h_dispatch = reg.histogram(
            "training_dispatch_ms", buckets=DECOMP_MS_BUCKETS,
            help="step decomposition: blocked pushing into the async "
                 "dispatch window (device back-pressure)",
        )._default()
        self._h_device = reg.histogram(
            "training_device_ms", buckets=DECOMP_MS_BUCKETS,
            help="step decomposition: device time between the step's "
                 "CUDA events, read at retirement",
        )._default()
        self._g_mfu = reg.gauge(
            "step_mfu",
            help="profiler: achieved / peak FLOP/s of the last step "
                 "(cost-model flops over measured wall; requires a "
                 "known peak)",
        )._default()
        self._g_fps = reg.gauge(
            "step_flops_per_sec",
            help="profiler: cost-model FLOPs / measured step wall",
        )._default()
        self._g_bps = reg.gauge(
            "step_bytes_per_sec",
            help="profiler: cost-model bytes accessed / measured "
                 "step wall",
        )._default()
        self._g_class = reg.gauge(
            "step_roofline_class",
            help="profiler: roofline classification of the last step "
                 "(0 unknown / 1 compute-bound / 2 memory-bound / "
                 "3 input-bound)",
        )._default()

    # -- hooks the seams call ---------------------------------------------

    def begin_step(self, step: int, parent=None, device=None) -> None:
        """Open step ``step``'s record; on a card (``device``) a CUDA
        event is recorded on its current stream."""
        if not self.enabled:
            return
        span = None
        if self.tracer is not None and self.tracer.enabled:
            span = self.tracer.start_span(
                "train.step", parent=parent, attrs={"step": int(step)})
        start = None
        if device is not None and getattr(device, "type", None) == "cuda":
            import torch

            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(device))
        self._state = _StepState(int(step), self._clock(), span, start)

    def note_input_wait_ms(self, ms: float) -> None:
        st = self._state
        if st is not None:
            st.input_ms += ms

    def note_dispatch_ms(self, ms: float) -> None:
        st = self._state
        if st is not None:
            st.dispatch_ms += ms

    def note_device_ms(self, ms: float) -> None:
        st = self._state
        if st is not None:
            st.device_ms += ms

    def note_listener_ms(self, ms: float) -> None:
        st = self._state
        if st is not None:
            st.listener_ms += ms

    # -- end of step --------------------------------------------------------

    def _retire(self, st: _StepState) -> None:
        """On the card: record the step's end event, wait for it, and add
        the device time between the pair."""
        if st.start is None:
            return
        import torch

        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        st.device_ms += st.start.elapsed_time(end)

    def _peak_of(self, model) -> Optional[float]:
        """The FLOP rate a step of ``model`` is held to: the caller's
        peak, else the table's for the model's compute dtype."""
        conf = getattr(model, "conf", None)
        if self._peak_given or conf is None:
            return self.peak
        dtype = getattr(conf, "compute_dtype", None) or conf.dtype
        return peak_flops(dtype=str(dtype))[0]

    def _cost_for(self, model, ds) -> Optional[CostModel]:
        try:
            sig = (id(model), id(getattr(model, "_step", None)),
                   _features_identity(ds))
        except (AttributeError, TypeError, IndexError):
            sig = None
        memo = self._cost_memo
        if sig is not None and memo is not None and memo[0] == sig:
            return memo[1]
        try:
            shape, dtype = _features_identity(ds)
            key = step_cost_key(model, shape, dtype)
        except (AttributeError, TypeError, IndexError):
            key = None
        cost = None
        if key is not None:
            cost = self.costs.get_or_build(
                key, lambda: train_step_cost_model(model, ds))
        if sig is not None:
            self._cost_memo = (sig, cost)
        return cost

    def end_step(self, model=None, ds=None, score=None, grad_norm=None,
                 rows=None, cost: Optional[CostModel] = None,
                 chunk: Optional[int] = None) -> Optional[dict]:
        """Close the open step: retire it (on the card), split its wall
        time, publish the gauges and histograms, append the recorder's
        record and end its span (a child span a part). Returns the
        record (None when disabled or unpaired). ``chunk=K`` marks a
        megastep record covering K optimizer steps (``step`` is the
        last one)."""
        st = self._state
        if not self.enabled or st is None:
            return None
        self._state = None
        self._retire(st)
        wall_ms = (self._clock() - st.t0) * 1000.0
        measured = st.input_ms + st.dispatch_ms + st.device_ms
        host_ms = max(0.0, wall_ms - measured)
        self._h_input.observe(st.input_ms)
        self._h_host.observe(host_ms)
        self._h_dispatch.observe(st.dispatch_ms)
        self._h_device.observe(st.device_ms)
        if cost is None and model is not None and ds is not None:
            cost = self._cost_for(model, ds)
        mfu = fps = bps = intensity = None
        klass = ROOFLINE_UNKNOWN
        if cost is not None:
            peak = self._peak_of(model)
            ach = cost.achieved(wall_ms / 1000.0, peak)
            fps, bps, mfu = (ach["flops_per_sec"], ach["bytes_per_sec"],
                             ach["mfu"])
            intensity = cost.arithmetic_intensity
            klass = cost.roofline_class(peak, self.peak_bw)
            self._g_fps.set(fps)
            self._g_bps.set(bps)
            if mfu is not None:
                self._g_mfu.set(mfu)
        if wall_ms > 0 and st.input_ms >= self.input_bound_frac * wall_ms:
            klass = ROOFLINE_INPUT
        self._g_class.set(float(klass))
        rec = {
            "step": st.step,
            "wall_ms": round(wall_ms, 3),
            "input_stall_ms": round(st.input_ms, 3),
            "host_ms": round(host_ms, 3),
            "dispatch_ms": round(st.dispatch_ms, 3),
            "device_ms": round(st.device_ms, 3),
            "listener_ms": round(st.listener_ms, 3),
            "roofline": ROOFLINE_NAMES[klass],
        }
        if score is not None:
            rec["loss"] = _as_number(score)
        if grad_norm is not None:
            rec["grad_norm"] = _as_number(grad_norm)
        if rows is not None:
            rec["rows"] = int(rows)
        if chunk is not None:
            rec["chunk"] = int(chunk)
        if cost is not None:
            rec["cost_key"] = cost.key
            if mfu is not None:
                rec["mfu"] = round(mfu, 6)
            rec["flops_per_sec"] = fps
            rec["arithmetic_intensity"] = (
                round(intensity, 3) if intensity is not None else None)
        span = st.span
        if span is not None:
            for name, ms in (("input", st.input_ms), ("host", host_ms),
                             ("dispatch", st.dispatch_ms),
                             ("device", st.device_ms)):
                self.tracer.start_span(
                    f"train.step.{name}", parent=span,
                    attrs={"ms": round(ms, 3)}).end()
            span.set_attr("wall_ms", round(wall_ms, 3))
            span.set_attr("roofline", ROOFLINE_NAMES[klass])
            rec["trace_id"] = span.context.trace_id
            span.end()
        if self.recorder is not None:
            self.recorder.record(**rec)
        return rec

    def abandon_step(self) -> None:
        """Drop an open step without a record (an exception unwinding)."""
        st = self._state
        self._state = None
        if st is not None and st.span is not None:
            st.span.end("error")

    def snapshot(self) -> dict:
        return {
            "enabled": self.enabled,
            "peak_flops": self.peak,
            "peak_flops_source": self.peak_source,
            "peak_bytes_per_sec": self.peak_bw,
            "peak_bytes_source": self.peak_bw_source,
            "input_bound_frac": self.input_bound_frac,
            "cost_models": self.costs.snapshot(),
        }


# -- the process-global profiler (as trace.get_tracer) -------------------

_ACTIVE: Optional[StepProfiler] = None


def get_active_profiler() -> Optional[StepProfiler]:
    return _ACTIVE


def set_active_profiler(prof: Optional[StepProfiler]
                        ) -> Optional[StepProfiler]:
    """Install ``prof`` process-globally (the fit paths, the prefetch
    iterator and the dispatch window read it); returns the previous
    one."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = prof
    return prev
