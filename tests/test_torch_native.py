"""The port's native data loader (``deeplearning4j_tpu_torch/native``)
on the CPU: built by g++ into ``deeplearning4j_tpu_torch/build/`` (never
beside its source), each function bit for bit its numpy route and the
JAX package's native functions, the MNIST and CIFAR-10 readers going
through it, and a failed build reported by ``route()`` as ``"numpy"``
with one warning."""

import struct
import warnings

import numpy as np
import pytest

import deeplearning4j_tpu.native as jnat
from deeplearning4j_tpu.datasets import mnist as jmnist
from deeplearning4j_tpu_torch import native as nat
from deeplearning4j_tpu_torch.datasets import (
    CifarDataSetIterator,
    MnistDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets import cifar, mnist


def _idx3(n, rows=28, cols=28, seed=0):
    imgs = np.random.RandomState(seed).randint(
        0, 256, (n, rows * cols)).astype(np.uint8)
    return struct.pack(">IIII", 2051, n, rows, cols) + imgs.tobytes(), imgs


def _cifar(n, seed=1):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    images = rng.randint(0, 256, (n, 3072)).astype(np.uint8)
    return np.concatenate([labels[:, None], images], 1).tobytes(), images, \
        labels


def test_the_loader_builds_into_the_build_directory():
    assert nat.route() == "native"
    so = nat.library_path()
    assert so.exists() and so.parent.name == "build"
    assert so.parent.parent.name == "deeplearning4j_tpu_torch"
    assert not list(nat.SOURCE.parent.glob("*.so"))


def _results():
    """(the port's arrays, the JAX package's) of every function on the
    same seeded bytes: the IDX3 parse, the normalize, the batch's x and
    y, the CIFAR images and labels."""
    buf, _ = _idx3(37)
    rng = np.random.RandomState(5)
    feats = rng.randint(0, 256, (60, 300)).astype(np.uint8)
    labels = rng.randint(0, 10, 60).astype(np.uint8)
    perm = rng.permutation(60)[:33]
    cbuf, _, _ = _cifar(9)
    return [(mod.parse_idx3(buf), mod.normalize_u8(feats),
             *mod.assemble_batch(feats, labels, perm, 10),
             *mod.split_cifar(cbuf)) for mod in (nat, jnat)]


def test_native_is_bitwise_the_numpy_route_and_the_jax_packages(
        monkeypatch):
    assert nat.route() == "native"
    native, jax_native = _results()
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_failure", "forced by the test")
    numpy, _ = _results()
    for got, by_numpy, ref in zip(native, numpy, jax_native):
        assert got.dtype == by_numpy.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(by_numpy, ref)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_bad_input_raises_on_both_routes(monkeypatch, route):
    if route == "numpy":
        monkeypatch.setattr(nat, "_lib", None)
        monkeypatch.setattr(nat, "_failure", "forced by the test")
    with pytest.raises(ValueError, match="bad IDX3 magic 1234"):
        nat.parse_idx3(struct.pack(">IIII", 1234, 1, 2, 2) + b"\0" * 4)
    with pytest.raises(ValueError, match="truncated"):
        nat.parse_idx3(struct.pack(">IIII", 2051, 3, 2, 2) + b"\0" * 4)
    with pytest.raises(ValueError, match="3073"):
        nat.split_cifar(b"\0" * 100)


def test_a_failed_build_is_the_numpy_route_with_one_warning(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_failure", None)
    monkeypatch.setattr(nat, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nat, "GXX", "no-such-compiler-for-the-loader")
    with pytest.warns(RuntimeWarning, match="numpy route"):
        assert nat.route() == "numpy"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert nat.route() == "numpy"  # warned once
        x, y = nat.assemble_batch(np.arange(6, dtype=np.uint8).reshape(3, 2),
                                  np.array([1, 0, 2], np.uint8),
                                  np.array([2, 0]), 3)
    np.testing.assert_array_equal(x, np.array([[4, 5], [0, 1]],
                                              np.float32) / np.float32(255))
    np.testing.assert_array_equal(y, np.eye(3, dtype=np.float32)[[2, 1]])


def test_a_fresh_build_lands_in_the_build_directory(monkeypatch, tmp_path):
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_failure", None)
    monkeypatch.setattr(nat, "BUILD_DIR", tmp_path / "build")
    assert nat.route() == "native"
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        nat.library_path().name]


def test_the_readers_go_through_the_loader(tmp_path, monkeypatch):
    buf, imgs = _idx3(20, seed=7)
    d = tmp_path / "mnist"
    d.mkdir()
    (d / "train-images-idx3-ubyte").write_bytes(buf)
    labels = np.random.RandomState(8).randint(0, 10, 20).astype(np.uint8)
    (d / "train-labels-idx1-ubyte").write_bytes(
        struct.pack(">II", 2049, 20) + labels.tobytes())
    np.testing.assert_array_equal(
        mnist.read_idx_images(str(d / "train-images-idx3-ubyte")), imgs)
    np.testing.assert_array_equal(
        mnist.read_idx_images(str(d / "train-images-idx3-ubyte")),
        jmnist.read_idx_images(str(d / "train-images-idx3-ubyte")))
    calls = []
    real = nat.assemble_batch
    monkeypatch.setattr(nat, "assemble_batch",
                        lambda *a: calls.append(1) or real(*a))
    ds = MnistDataSetIterator(8, data_dir=str(d), seed=3).next()
    order = np.random.RandomState(3).permutation(20)[:8]
    np.testing.assert_array_equal(
        ds.features, imgs[order].astype(np.float32) / np.float32(255.0))
    np.testing.assert_array_equal(ds.labels.argmax(1), labels[order])
    cbuf, cimgs, clabels = _cifar(6)
    c = tmp_path / "cifar"
    c.mkdir()
    for i in range(1, 6):
        (c / f"data_batch_{i}.bin").write_bytes(cbuf)
    got, lab = cifar.read_bin(str(c / "data_batch_1.bin"))
    np.testing.assert_array_equal(got.reshape(6, -1), cimgs)
    np.testing.assert_array_equal(lab, clabels)
    cds = CifarDataSetIterator(4, data_dir=str(c), shuffle=False).next()
    np.testing.assert_array_equal(
        cds.features.reshape(4, -1),
        cimgs[:4].astype(np.float32) / np.float32(255.0))
    assert len(calls) == 2
    with pytest.raises(ValueError, match="bad IDX3 magic .* in"):
        (d / "bad").write_bytes(struct.pack(">IIII", 7, 1, 1, 1) + b"\0")
        mnist.read_idx_images(str(d / "bad"))
