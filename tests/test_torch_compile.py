"""The port's ``compile/`` on the CPU: the AOT framing against the JAX
package's byte for byte, the fingerprint's fields, stale and foreign
artifacts falling back (``aot_fallback_total``), the kernel-library
cache's pruning order against JAX's ``bound_cache_size`` and its
directory resolution, the serving bundle's round trip through
``CheckpointManager`` artifacts with a dummy library file (no ``nvcc``
here: the build is made to raise if anything reached it), and the
train step's kind refusals."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_serving_models as M
from deeplearning4j_tpu.compile import aot as jaot
from deeplearning4j_tpu.compile import persistent as jpersistent
from deeplearning4j_tpu_torch.compile import aot, persistent
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.resilience.checkpoint import CheckpointManager
from deeplearning4j_tpu_torch.serving import ModelServer
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

METAS = [{}, {"format": "x", "shape": [4, 6], "n": 3},
         {"b": [1, {"z": None}], "a": "ü"}]
BLOBS = [b"", b"\x00\x01payload" * 7, bytes(range(256))]


@pytest.mark.parametrize("meta", METAS)
@pytest.mark.parametrize("blob", BLOBS)
def test_framing_is_jax_byte_for_byte(meta, blob):
    data = aot.pack_artifact(meta, blob)
    assert data == jaot.pack_artifact(meta, blob)
    assert aot.MAGIC == jaot.MAGIC == b"DL4JAOT1"
    # JAX-packed bytes unpack in the port, and the other way
    assert aot.unpack_artifact(jaot.pack_artifact(meta, blob)) == (meta, blob)
    assert jaot.unpack_artifact(data) == (meta, blob)
    assert aot.peek_meta(data) == meta


@pytest.mark.parametrize("bad", [
    b"", b"DL4JAOT", b"NOTMAGIC\x00\x00\x00\x00",
    aot.pack_artifact({"a": 1}, b"xyz")[:14],
    aot.MAGIC + (50).to_bytes(4, "little") + b"{}",
    aot.MAGIC + (4).to_bytes(4, "little") + b"{{{{",
    aot.MAGIC + (2).to_bytes(4, "little") + b"[]",
    "not bytes"], ids=range(8))
def test_garbage_and_truncated_bytes_raise(bad):
    with pytest.raises(aot.AotArtifactError):
        aot.unpack_artifact(bad)


def _conf():
    return M.jax_mlp().conf.to_dict()


def test_each_fingerprint_field_changes_it(monkeypatch):
    base = dict(conf=_conf(), shape=(4, 6), dtype="float32", kind="output")
    ref = aot.artifact_fingerprint(**base)
    assert ref == aot.artifact_fingerprint(**base)  # deterministic
    other = _conf()
    other["seed"] = 99
    variants = [dict(base, conf=other), dict(base, shape=(8, 6)),
                dict(base, shape=((4, 6),)), dict(base, dtype="bfloat16"),
                dict(base, kind="output+scan"),
                dict(base, backend="cuda:sm_80"), dict(base, extra="x")]
    prints = {aot.artifact_fingerprint(**v) for v in variants}
    assert ref not in prints and len(prints) == len(variants)
    for patch in (lambda: monkeypatch.setattr(torch, "__version__", "0.0"),
                  lambda: monkeypatch.setattr(torch.version, "cuda", "1.0"),
                  lambda: monkeypatch.setattr(_build, "_digest",
                                              lambda: "f" * 16)):
        patch()
        assert aot.artifact_fingerprint(**base) != ref
        monkeypatch.undo()
    assert aot.artifact_fingerprint(**base) == ref


def _fallbacks(reg):
    return aot._instruments(reg)["fallback"].value


@pytest.fixture
def mlp(tmp_path):
    return M.pair("mlp", tmp_path)


def test_stale_and_foreign_artifacts_fall_back(mlp, tmp_path):
    _, path, net = mlp
    reg = MetricsRegistry()
    good = net.aot_export_output((4, 6), registry=reg)
    assert net.aot_install_output((4, 6), good, registry=reg)
    assert net.aot_output_shapes() == [(4, 6)]
    # another shape, another model, garbage: refused and counted
    other = restore_model(M.pair("mlp", tmp_path, seed=8)[1], device="cpu")
    stale = [(net, (8, 6), good), (other, (4, 6), good),
             (net, (4, 6), good[:20]), (net, (4, 6), b"garbage")]
    for i, (model, shape, data) in enumerate(stale, 1):
        assert not model.aot_install_output(shape, data, registry=reg)
        assert _fallbacks(reg) == i
    assert aot._instruments(reg)["installed"].value == 1


@pytest.fixture
def fake_library(tmp_path, monkeypatch):
    """A dummy library file standing for the built one, and no nvcc:
    anything that reaches the build raises."""
    lib = tmp_path / "built" / _build.library_name()
    lib.parent.mkdir()
    lib.write_bytes(b"\x7fELF dummy kernel library " * 100)
    monkeypatch.setattr(aot, "_library_path", lambda: lib)

    def no_nvcc():
        raise AssertionError("nvcc must not be reached")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    prev = _build._cache_dir
    yield lib
    _build.set_cache_dir(prev)


def test_library_of_another_digest_is_refused(fake_library, tmp_path,
                                              monkeypatch):
    reg = MetricsRegistry()
    good = aot.export_library(registry=reg)
    monkeypatch.setattr(_build, "_digest", lambda: "0" * 16)
    foreign = aot.export_library(registry=reg)
    monkeypatch.undo()
    monkeypatch.setattr(aot, "_library_path", lambda: fake_library)
    _build.set_cache_dir(tmp_path / "cache")
    assert aot.install_library(foreign, registry=reg) is None
    assert _fallbacks(reg) == 1
    # a payload that does not match its recorded hash
    meta, blob = aot.unpack_artifact(good)
    assert aot.install_library(aot.pack_artifact(meta, blob[:-3]),
                               registry=reg) is None
    assert _fallbacks(reg) == 2
    assert not (tmp_path / "cache").exists()
    path = aot.install_library(good, registry=reg)
    assert path == tmp_path / "cache" / _build.library_name()
    assert path.read_bytes() == fake_library.read_bytes()
    assert not [p for p in path.parent.iterdir() if p.suffix == ".tmp"]


def test_serving_bundle_round_trip_through_checkpoint_artifacts(
        fake_library, mlp, tmp_path):
    jnet, path, net = mlp
    bundle = aot.export_serving_bundle(net, [1, 2, 4])
    assert sorted(bundle) == [aot.LIBRARY_ARTIFACT, "aot-output-b1",
                              "aot-output-b2", "aot-output-b4"]
    assert aot.peek_meta(bundle["aot-output-b4"])["shape"] == [4, 6]
    assert aot.peek_meta(bundle[aot.LIBRARY_ARTIFACT])["format"] == (
        "cuda-kernel-library")
    mgr = CheckpointManager(tmp_path / "ckpt", device="cpu")
    mgr.save(net, artifacts=bundle)
    blobs = mgr.load_artifacts(mgr.available()[-1])
    assert blobs == bundle
    cache = tmp_path / "empty-cache"
    server = ModelServer(checkpoint_manager=mgr, device="cpu",
                         compile_cache=str(cache), max_batch_size=4).start()
    try:
        lib = cache / _build.library_name()
        assert lib.read_bytes() == fake_library.read_bytes()
        snap = server.metrics_snapshot()
        assert snap["compile"]["aot_buckets_installed"] == 3
        assert snap["compile"]["persistent_cache_dir"] == str(cache)
        # every warm-up bucket was preloaded: no first forward counted
        assert snap["counters"]["xla_compiles_total"] == 0
        assert snap["counters"]["warmup_predicts_total"] == 3
        reg = server.metrics.registry
        assert reg.get("aot_installed_total").value == 4
        assert reg.get("aot_fallback_total").value == 0
    finally:
        server.stop()
    # a corrupt bucket record: counted, that bucket counts as new
    bad = dict(bundle, **{"aot-output-b2": b"DL4JAOT1garbage"})
    net.iteration_count = 1
    mgr.save(net, artifacts=bad)
    server = ModelServer(checkpoint_manager=mgr, device="cpu",
                         compile_cache=str(cache), max_batch_size=4).start()
    try:
        snap = server.metrics_snapshot()
        assert snap["compile"]["aot_buckets_installed"] == 2
        assert server.metrics.registry.get("aot_fallback_total").value == 1
        assert snap["counters"]["xla_compiles_total"] == 1
    finally:
        server.stop()


def _touch(d: Path, name: str, size: int, mtime: float) -> None:
    p = d / name
    p.write_bytes(b"x" * size)
    os.utime(p, (mtime, mtime))


@pytest.mark.parametrize("max_bytes", [0, 350, 600, 10_000])
def test_bound_cache_size_prunes_in_jax_order(tmp_path, max_bytes,
                                              monkeypatch):
    rng = np.random.RandomState(max_bytes)
    specs = [(f"{_build.LIB_PREFIX}{i:016x}.so", int(rng.randint(50, 200)),
              1_000_000.0 + float(rng.permutation(8)[i]) * 10)
             for i in range(8)]
    dirs = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        for name, size, mtime in specs:
            _touch(d, name, size, mtime)
        dirs[side] = d
    monkeypatch.setattr(_build, "loaded_path", None)
    removed = persistent.bound_cache_size(dirs["port"], max_bytes)
    assert removed == jpersistent.bound_cache_size(dirs["jax"], max_bytes)
    assert (sorted(p.name for p in dirs["port"].iterdir())
            == sorted(p.name for p in dirs["jax"].iterdir()))


def test_bound_cache_size_keeps_the_loaded_library_and_others(tmp_path,
                                                              monkeypatch):
    oldest = f"{_build.LIB_PREFIX}{'a' * 16}.so"
    _touch(tmp_path, oldest, 100, 1_000_000.0)
    _touch(tmp_path, f"{_build.LIB_PREFIX}{'b' * 16}.so", 100, 1_000_010.0)
    _touch(tmp_path, "conv_block-1-2.o", 100, 999_000.0)  # a build's object
    monkeypatch.setattr(_build, "loaded_path", tmp_path / oldest)
    assert persistent.bound_cache_size(tmp_path, 150) == 100
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "conv_block-1-2.o", oldest]


def test_cache_directory_resolution_order(tmp_path, monkeypatch):
    monkeypatch.delenv(persistent.ENV_CACHE_DIR, raising=False)
    assert persistent.resolve_cache_dir() == str(_build.BUILD_DIR)
    monkeypatch.setenv(persistent.ENV_CACHE_DIR, str(tmp_path / "env"))
    assert persistent.resolve_cache_dir() == str(tmp_path / "env")
    assert persistent.resolve_cache_dir(tmp_path / "arg") == str(
        tmp_path / "arg")
    monkeypatch.setenv(persistent.ENV_CACHE_DIR, "off")
    assert persistent.resolve_cache_dir() is None
    assert persistent.enable_persistent_cache() is None
    prev = _build._cache_dir
    try:
        monkeypatch.setenv(persistent.ENV_CACHE_DIR, str(tmp_path / "env"))
        reg = MetricsRegistry()
        got = persistent.enable_persistent_cache(registry=reg)
        assert got == str(tmp_path / "env") and Path(got).is_dir()
        assert _build.cache_dir() == tmp_path / "env"
        # a lookup is a hit (library found) or a miss (a build)
        before = persistent.cache_stats()
        _build._notify("hit", tmp_path / "x.so")
        _build._notify("miss", tmp_path / "x.so", 2.5)
        after = persistent.cache_stats()
        assert after["hits"] == before["hits"] + 1
        assert after["misses"] == before["misses"] + 1
        assert reg.get("compile_cache_hits_total").value == 1
        assert reg.get("compile_cache_misses_total").value == 1
        assert reg.get("xla_backend_compiles_total").value == 1
        assert reg.get("xla_backend_compile_seconds_total").value == 2.5
        assert "nvcc build of the kernel library" in reg.get(
            "compile_cache_hits_total").help
    finally:
        _build.set_cache_dir(prev)


@pytest.mark.parametrize("change", ["remat", "loss_scale", "accum",
                                    "zero", "scan", "guard", "megastep"])
def test_step_artifact_of_another_kind_is_refused(mlp, change, monkeypatch):
    from deeplearning4j_tpu_torch.nn import core
    from deeplearning4j_tpu_torch.resilience.guard import DivergenceGuard

    _, path, _ = mlp
    net = restore_model(path, device="cpu")
    x = M.rows("mlp", 4, 0)
    ds = DataSet(x, np.eye(3, dtype=np.float32)[[0, 1, 2, 0]])
    reg = MetricsRegistry()
    art = net.aot_export_step(ds, registry=reg)
    assert aot.peek_meta(art)["label_shape"] == [4, 3]
    other = restore_model(path, device="cpu")
    if change == "remat":
        other.set_transforms(remat="full")
    elif change == "loss_scale":  # as under f16 compute
        monkeypatch.setattr(core, "loss_scale_active", lambda m: m is other)
    elif change == "accum":
        other.grad_accum = 2
    elif change == "zero":
        other._zero_layout = {"shards": 2}
    elif change == "scan":
        other.set_transforms(scan_layers=True)
    elif change == "megastep":
        other.set_transforms(megastep=2)
    else:
        other.set_divergence_guard(DivergenceGuard("skip"))
    assert not other.aot_install_step(art, registry=reg)
    assert _fallbacks(reg) == 1
    # the same kind installs, and the step it wraps trains as before
    assert net.aot_install_step(art, registry=reg)
    assert isinstance(net._step, aot.AotStepFunction)
    assert net._step.kind == "step" and net._step.x_shape == (4, 6)
    twin = restore_model(path, device="cpu")
    net.fit_minibatch(ds)
    twin.fit_minibatch(ds)
    np.testing.assert_array_equal(net.params_flat(), twin.params_flat())


def test_graph_step_and_output_artifacts_use_nested_keys(tmp_path):
    _, _, net = M.pair("vgg", tmp_path)
    reg = MetricsRegistry()
    art = net.aot_export_output((2, 3, 8, 8), registry=reg)
    assert aot.peek_meta(art)["shape"] == [[2, 3, 8, 8]]
    assert net.aot_install_output(((2, 3, 8, 8),), art, registry=reg)
    assert net.aot_output_shapes() == [((2, 3, 8, 8),)]
    ds = DataSet(np.zeros((2, 3, 8, 8), np.float32),
                 np.eye(10, dtype=np.float32)[[1, 2]])
    step = net.aot_export_step(ds, registry=reg)
    assert net.aot_install_step(step, registry=reg)
    assert net._step.y_shape == ((2, 10),)
