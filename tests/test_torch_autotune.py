"""The port's kernel tuner (``deeplearning4j_tpu_torch/ops/autotune.py``)
on the CPU, case by case after JAX ``tests/test_autotune.py``: the modes
and their knobs, cached never measures, on measures / persists /
re-hits, the per-process memo, mangled and stale entries refused and
counted, a warm cache in a second process that measures nothing. The
measure factories and the timer are fakes (the card's timer is CUDA
events: ``tests/test_torch_cuda.py`` runs it); where the port differs
from JAX, the test says so: a failing candidate raises, and with no
cache directory ``cached`` is the heuristic at each launch, unmemoized.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.observability.metrics import default_registry
from deeplearning4j_tpu_torch.ops import autotune, conv_block, dispatch, tiling

# a synthetic subject: resolve() is generic over (kernel, identity,
# candidates), so the cache and fallback machinery is testable without
# a card
CANDS = [("tiled", 1), ("tiled", 2), ("wide", 1)]
HEUR = ("tiled", 2)
IDENT = {"m": 8, "k": 64, "n": 8, "dtype": "f32"}
KERNEL = "matmul_block"
# the fake timer's ms a call, by plan: "wide" wins
FAKE_MS = {("tiled", 1): 3.0, ("tiled", 2): 2.0, ("wide", 1): 1.0}


@pytest.fixture(autouse=True)
def cold_tuner():
    dispatch.reset_for_tests()
    yield
    dispatch.reset_for_tests()


def _counter(name, **labels):
    fam = default_registry().get(name)
    if fam is None:
        return 0.0
    if labels:
        return fam.labels(**labels).value
    return float(sum(c.value for c in fam.children()))


def _measure_count():
    fam = default_registry().get("tuner_measure_ms")
    if fam is None:
        return 0
    return int(sum(c.count for c in fam.children()))


def _factory_counting(calls):
    def factory(plan):
        def run():
            calls.append(tuple(plan))
        run.plan = tuple(plan)
        return run
    return factory


def fake_timer(fn, n):
    for _ in range(n):
        fn()
    return FAKE_MS[fn.plan]


def _resolve(factory=None, heuristic=HEUR, candidates=CANDS):
    return autotune.resolve(KERNEL, IDENT, heuristic, candidates,
                            measure_factory=factory, timer=fake_timer)


def _arm(monkeypatch, mode, cache_dir=None, budget_ms=None):
    monkeypatch.setenv("DL4J_TPU_TUNE", mode)
    if cache_dir is not None:
        monkeypatch.setenv("DL4J_TPU_TUNE_CACHE_DIR", str(cache_dir))
    else:
        monkeypatch.delenv("DL4J_TPU_TUNE_CACHE_DIR", raising=False)
    if budget_ms is not None:
        monkeypatch.setenv("DL4J_TPU_TUNE_BUDGET_MS", str(budget_ms))
    else:
        monkeypatch.delenv("DL4J_TPU_TUNE_BUDGET_MS", raising=False)
    dispatch.reset_for_tests()


class TestModeSemantics:
    def test_default_mode_is_cached(self, monkeypatch):
        monkeypatch.delenv("DL4J_TPU_TUNE", raising=False)
        dispatch.reset_for_tests()
        assert autotune.tuning_mode() == "cached"

    def test_off_mode_is_inactive(self, monkeypatch):
        _arm(monkeypatch, "off")
        assert autotune.tuning_mode() == "off"

    def test_unknown_mode_falls_back_to_cached(self, monkeypatch):
        _arm(monkeypatch, "bogus")
        assert autotune.tuning_mode() == "cached"

    def test_reset_for_tests_rereads_env(self, monkeypatch):
        """Read once: flipping the env does nothing until
        dispatch.reset_for_tests() cascades into the tuner."""
        _arm(monkeypatch, "off")
        assert autotune.tuning_mode() == "off"
        monkeypatch.setenv("DL4J_TPU_TUNE", "on")
        assert autotune.tuning_mode() == "off"  # the first read sticks
        dispatch.reset_for_tests()
        assert autotune.tuning_mode() == "on"

    def test_budget_and_cache_dir_knobs(self, monkeypatch, tmp_path):
        _arm(monkeypatch, "on", cache_dir=tmp_path, budget_ms="123.5")
        assert autotune.cache_dir() == str(tmp_path)
        assert autotune.measure_budget_ms() == 123.5

    def test_bad_budget_falls_back_to_default(self, monkeypatch):
        _arm(monkeypatch, "on", budget_ms="not-a-number")
        assert autotune.measure_budget_ms() == 2000.0


class TestResolution:
    def test_off_mode_returns_heuristic_untouched(self, monkeypatch):
        _arm(monkeypatch, "off")
        calls = []
        assert _resolve(_factory_counting(calls)) == HEUR
        assert calls == []

    def test_cached_without_a_directory_is_the_heuristic_unmemoized(
            self, monkeypatch):
        """The port's default: nothing to look up, so each launch takes
        the route function's plan (no memo, no count), as before the
        tuner; a patched route is seen at once."""
        _arm(monkeypatch, "cached")
        f0 = _counter("tuner_fallback_total")
        assert _resolve(heuristic=lambda: HEUR,
                        candidates=lambda: 1 / 0) == HEUR
        assert _resolve(heuristic=("wide", 1)) == ("wide", 1)
        assert autotune.resolved() == {}
        assert _counter("tuner_fallback_total") == f0

    def test_cached_miss_falls_back_and_counts(self, monkeypatch, tmp_path):
        _arm(monkeypatch, "cached", cache_dir=tmp_path)
        before = _counter("tuner_fallback_total", kernel=KERNEL,
                          reason="absent")
        assert _resolve() == HEUR
        assert _counter("tuner_fallback_total", kernel=KERNEL,
                        reason="absent") == before + 1

    def test_cached_mode_never_measures(self, monkeypatch, tmp_path):
        _arm(monkeypatch, "cached", cache_dir=tmp_path)
        calls = []
        m0, s0 = _measure_count(), _counter("tuner_searches_total")
        assert _resolve(_factory_counting(calls)) == HEUR
        assert calls == []
        assert _measure_count() == m0
        assert _counter("tuner_searches_total") == s0

    def test_on_mode_searches_persists_and_rehits(self, monkeypatch,
                                                  tmp_path):
        _arm(monkeypatch, "on", cache_dir=tmp_path)
        calls = []
        s0 = _counter("tuner_searches_total", kernel=KERNEL)
        got = _resolve(_factory_counting(calls))
        assert got == ("wide", 1)  # the fastest as measured
        assert _counter("tuner_searches_total", kernel=KERNEL) == s0 + 1
        assert HEUR in set(calls)  # the heuristic is always measured
        doc = autotune.read_entry(KERNEL, IDENT)
        assert doc["kernel"] == KERNEL and doc["config"] == ["wide", 1]
        assert doc["fingerprint"] == autotune.fingerprint(KERNEL)
        assert doc["heuristic"] == list(HEUR)
        assert doc["timings_ms"] == {tiling.plan_tag(p): FAKE_MS[p]
                                     for p in CANDS}
        assert doc["best_ms"] <= doc["timings_ms"][tiling.plan_tag(HEUR)]
        # a fresh memo in cached mode: a disk hit, no factory call
        _arm(monkeypatch, "cached", cache_dir=tmp_path)
        h0 = _counter("tuner_cache_hits_total", kernel=KERNEL)
        calls2 = []
        assert _resolve(_factory_counting(calls2)) == got
        assert calls2 == []
        assert _counter("tuner_cache_hits_total", kernel=KERNEL) == h0 + 1

    def test_resolution_is_memoized_per_process(self, monkeypatch,
                                                tmp_path):
        _arm(monkeypatch, "on", cache_dir=tmp_path)
        got = _resolve(_factory_counting([]))
        with open(autotune.entry_path(KERNEL, IDENT), "w") as f:
            f.write("{mangled")
        s0 = _counter("tuner_searches_total")
        assert _resolve(_factory_counting([])) == got
        assert _counter("tuner_searches_total") == s0
        assert autotune.resolved()[(KERNEL, tuple(IDENT.items()))] == got

    def test_no_cache_dir_on_mode_still_tunes(self, monkeypatch):
        _arm(monkeypatch, "on")
        assert autotune.entry_path(KERNEL, IDENT) is None
        assert _resolve(_factory_counting([])) == ("wide", 1)

    def test_unwritable_cache_keeps_the_winner_in_the_memo(self,
                                                           monkeypatch,
                                                           tmp_path):
        """Persisting is best effort, as in JAX: a cache path that cannot
        be written still tunes, and the winner serves this process."""
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        _arm(monkeypatch, "on", cache_dir=blocker / "cache")
        assert _resolve(_factory_counting([])) == ("wide", 1)
        assert autotune.read_entry(KERNEL, IDENT) is None
        assert _resolve(lambda p: pytest.fail("re-measured")) == ("wide", 1)

    def test_budget_measures_the_heuristic_alone_when_spent(self,
                                                            monkeypatch,
                                                            tmp_path):
        """A spent budget still measures the heuristic (round 0, first),
        and leaves out the plans it had no time for."""
        _arm(monkeypatch, "on", cache_dir=tmp_path, budget_ms="-1")
        calls = []
        assert _resolve(_factory_counting(calls)) == HEUR
        assert set(calls) == {HEUR}
        assert autotune.read_entry(KERNEL, IDENT)["measured"] == 1

    def test_search_is_the_heuristic_and_the_top_k_by_prior(self,
                                                            monkeypatch):
        _arm(monkeypatch, "on")
        cands = [("tiled", s) for s in range(1, 9)] + [("wide", 1)]
        calls = []

        def factory(plan):
            def run():
                calls.append(plan)
            run.plan = plan
            return run

        got = autotune.resolve(
            KERNEL, IDENT, ("tiled", 8), cands,
            cost_fn=lambda p: -p[1] if p[0] == "tiled" else 100,
            measure_factory=factory, timer=lambda fn, n: (fn(), 1.0)[1])
        measured = set(calls)
        assert measured == {("tiled", 8), ("tiled", 7), ("tiled", 6),
                            ("tiled", 5), ("tiled", 4)}
        assert got in measured

    def test_a_failing_candidate_raises_naming_its_plan(self, monkeypatch):
        """Where the port differs from JAX (its _FAILED sentinel drops
        the plan): a kernel fault on a card must not be hidden."""
        _arm(monkeypatch, "on")

        def factory(plan):
            def run():
                if plan == ("tiled", 1):
                    raise RuntimeError("cudaError 700")
            run.plan = plan
            return run
        with pytest.raises(RuntimeError, match=r"matmul_block plan tiled:1 "
                           r"failed.*cudaError 700"):
            _resolve(factory)

    def test_kernels_on_cpu_tensors_never_consult_the_tuner(self,
                                                            monkeypatch,
                                                            tmp_path):
        _arm(monkeypatch, "on", cache_dir=tmp_path)
        monkeypatch.setattr(autotune, "resolve",
                            lambda *a, **k: pytest.fail("tuner consulted"))
        x = torch.randn(2, 3, 8, 8)
        w = torch.randn(4, 3, 3, 3)
        y = conv_block(x, w, padding=(1, 1), activation="relu")
        assert y.shape == (2, 4, 8, 8) and os.listdir(tmp_path) == []


def _write_valid_entry(plan=("wide", 1)):
    path = autotune.entry_path(KERNEL, IDENT)
    autotune._persist(path, {
        "format": 1, "fingerprint": autotune.fingerprint(KERNEL),
        "kernel": KERNEL, "identity": IDENT, "config": list(plan),
        "heuristic": list(HEUR), "best_ms": 1.0, "measured": 1,
        "timings_ms": {tiling.plan_tag(plan): 1.0}})
    return path


def _edit(path, fn):
    with open(path) as f:
        doc = json.load(f)
    fn(doc)
    with open(path, "w") as f:
        json.dump(doc, f)


class TestCacheIntegrity:
    @pytest.mark.parametrize("mangle,reason", [
        ("{nope", "corrupt"),
        ("truncate", "corrupt"),
        ("[1, 2]", "corrupt"),
        ("config:[1, 2]", "corrupt"),
        ("torch", "stale"),
        ("card", "stale"),
        ("library", "stale"),
        ("format", "stale"),
        ("invalid", "invalid"),
    ])
    def test_mangled_entry_falls_back(self, monkeypatch, tmp_path, mangle,
                                      reason):
        _arm(monkeypatch, "cached", cache_dir=tmp_path)
        path = _write_valid_entry()
        if mangle == "truncate":
            raw = open(path).read()
            open(path, "w").write(raw[:20])
        elif mangle == "config:[1, 2]":
            _edit(path, lambda d: d.__setitem__("config", [1, 2]))
        elif mangle == "torch":
            _edit(path, lambda d: d["fingerprint"].__setitem__("torch",
                                                               "0.0.0"))
        elif mangle == "card":
            _edit(path, lambda d: d["fingerprint"].__setitem__(
                "device", "NVIDIA A100-SXM4-80GB"))
        elif mangle == "library":
            _edit(path, lambda d: d["fingerprint"].__setitem__("library",
                                                               "0" * 16))
        elif mangle == "format":
            _edit(path, lambda d: d.__setitem__("format", 0))
        elif mangle == "invalid":
            _edit(path, lambda d: d.__setitem__("config", ["wide", 2]))
        else:
            open(path, "w").write(mangle)
        before = _counter("tuner_fallback_total", kernel=KERNEL,
                          reason=reason)
        assert _resolve() == HEUR
        assert _counter("tuner_fallback_total", kernel=KERNEL,
                        reason=reason) == before + 1

    def test_valid_entry_hits(self, monkeypatch, tmp_path):
        _arm(monkeypatch, "cached", cache_dir=tmp_path)
        _write_valid_entry()
        h0 = _counter("tuner_cache_hits_total", kernel=KERNEL)
        assert _resolve() == ("wide", 1)
        assert _counter("tuner_cache_hits_total", kernel=KERNEL) == h0 + 1

    def test_on_mode_refused_entry_remeasures_and_overwrites(
            self, monkeypatch, tmp_path):
        _arm(monkeypatch, "on", cache_dir=tmp_path)
        path = _write_valid_entry(("tiled", 1))
        _edit(path, lambda d: d["fingerprint"].__setitem__("torch", "0.0.0"))
        f0 = _counter("tuner_fallback_total", kernel=KERNEL, reason="stale")
        s0 = _counter("tuner_searches_total", kernel=KERNEL)
        assert _resolve(_factory_counting([])) == ("wide", 1)
        assert _counter("tuner_fallback_total", kernel=KERNEL,
                        reason="stale") == f0 + 1
        assert _counter("tuner_searches_total", kernel=KERNEL) == s0 + 1
        with open(path) as f:
            assert json.load(f)["fingerprint"] == autotune.fingerprint(KERNEL)

    def test_fingerprint_names_the_environment(self):
        fp = autotune.fingerprint("conv_block")
        assert fp != autotune.fingerprint("matmul_block")
        assert fp["torch"] == torch.__version__
        assert fp["cuda"] == torch.version.cuda
        assert set(fp) == {"kind", "torch", "cuda", "device", "capability",
                           "library", "format"}
        from deeplearning4j_tpu_torch.ops import _build
        assert fp["library"] == _build._digest()

    def test_a_stale_entry_sits_where_a_fresh_one_would(self, monkeypatch,
                                                        tmp_path):
        """The file name keys on the kernel and the shape alone, so an
        entry another torch wrote is found (and refused as stale), not
        silently absent."""
        _arm(monkeypatch, "cached", cache_dir=tmp_path)
        path = autotune.entry_path(KERNEL, IDENT)
        monkeypatch.setattr(autotune, "_ENVIRONMENT",
                            dict(autotune.environment(), torch="0.0.0"))
        assert autotune.entry_path(KERNEL, IDENT) == path


_CHILD = r"""
import json
from deeplearning4j_tpu_torch.ops import autotune
from deeplearning4j_tpu_torch.observability.metrics import default_registry

calls = []
MS = {("tiled", 1): 3.0, ("tiled", 2): 2.0, ("wide", 1): 1.0}
def factory(plan):
    def run():
        calls.append(plan)
    run.plan = plan
    return run

got = autotune.resolve(
    "matmul_block", {"m": 8, "k": 64, "n": 8, "dtype": "f32"}, ("tiled", 2),
    [("tiled", 1), ("tiled", 2), ("wide", 1)], measure_factory=factory,
    timer=lambda fn, n: [fn() for _ in range(n)] and MS[fn.plan])

def total(name):
    fam = default_registry().get(name)
    return 0 if fam is None else sum(c.value for c in fam.children())

print(json.dumps({"config": list(got), "measure_calls": len(calls),
                  "searches": total("tuner_searches_total"),
                  "hits": total("tuner_cache_hits_total")}))
"""


def test_second_process_with_warm_cache_measures_nothing(tmp_path):
    env = {**os.environ, "DL4J_TPU_TUNE_CACHE_DIR": str(tmp_path),
           "DL4J_TPU_TUNE": "on", "DL4J_TPU_TUNE_BUDGET_MS": "500"}

    def run():
        out = subprocess.run(
            [sys.executable, "-c", _CHILD], capture_output=True, text=True,
            timeout=120, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert out.returncode == 0, out.stderr[-2000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    cold = run()
    assert cold["searches"] == 1 and cold["measure_calls"] > 0
    assert cold["config"] == ["wide", 1]
    warm = run()  # mode on again: the persisted entry short-circuits
    assert warm["searches"] == 0 and warm["measure_calls"] == 0
    assert warm["hits"] == 1 and warm["config"] == cold["config"]


def test_chaos_mangled_tuning_cache_storm(monkeypatch, tmp_path):
    """Many shapes, their entries mangled at random: every resolution is
    a hit or the heuristic, never a plan outside the candidates, and
    every refusal is counted."""
    rng = np.random.RandomState(1337)
    _arm(monkeypatch, "on", cache_dir=tmp_path)
    idents = [{"m": int(m), "k": 64, "n": 8, "dtype": "f32"}
              for m in range(1, 41)]
    for ident in idents:
        autotune.resolve(KERNEL, ident, HEUR, CANDS,
                         measure_factory=_factory_counting([]),
                         timer=fake_timer)
    mangled = 0
    for ident in idents:
        path = autotune.entry_path(KERNEL, ident)
        kind = rng.randint(4)
        if kind == 0:
            open(path, "w").write("{")
        elif kind == 1:
            _edit(path, lambda d: d["fingerprint"].__setitem__("cuda", "x"))
        elif kind == 2:
            _edit(path, lambda d: d.__setitem__("config", ["tiled", 99]))
        mangled += kind != 3
    _arm(monkeypatch, "cached", cache_dir=tmp_path)
    f0 = _counter("tuner_fallback_total")
    h0 = _counter("tuner_cache_hits_total")
    for ident in idents:
        got = autotune.resolve(KERNEL, ident, HEUR, CANDS)
        assert got in CANDS
    assert _counter("tuner_fallback_total") - f0 == mangled
    assert _counter("tuner_cache_hits_total") - h0 == len(idents) - mangled
