"""The port's NDArray streaming (``deeplearning4j_tpu_torch/streaming``)
against the JAX package's, on the CPU: the wire bytes are equal, a
publisher of either package feeds a consumer of the other, and a fit
fed over a loopback stream (``StreamingDataSetIterator``) is bitwise
the same fit fed from a list. Consumers bind port 0 (xdist)."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import streaming as jstreaming
from deeplearning4j_tpu_torch import serving, streaming
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo import lenet


@pytest.mark.parametrize("labels", [True, False])
def test_wire_bytes_equal_jax(labels):
    rng = np.random.RandomState(0)
    f = rng.rand(3, 1, 4, 5).astype(np.float32)
    lab = rng.rand(3, 2).astype(np.float32) if labels else None
    body = streaming.encode_ndarray_message(f, lab)
    assert body == jstreaming.encode_ndarray_message(f, lab)
    # a tensor publishes as its host array, f64 as f32 (as JAX casts)
    assert streaming.encode_ndarray_message(
        f.astype(np.float64), lab) == body
    for decode in (streaming.decode_ndarray_message,
                   jstreaming.decode_ndarray_message):
        f2, l2 = decode(body[8:])
        np.testing.assert_array_equal(f2, f)
        if labels:
            np.testing.assert_array_equal(l2, lab)
        else:
            assert l2 is None


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_one_packages_publisher_feeds_the_others_consumer(publisher):
    rng = np.random.RandomState(1)
    pub_mod, con_mod = ((jstreaming, streaming) if publisher == "jax"
                        else (streaming, jstreaming))
    consumer = con_mod.NDArrayConsumer(port=0).listen()
    pub = pub_mod.NDArrayPublisher("127.0.0.1", consumer.port)
    sent = [rng.rand(6).astype(np.float32) for _ in range(5)]
    try:
        for a in sent:
            if publisher == "port":
                pub.publish(torch.from_numpy(a), labels=a * 2)
            else:
                pub.publish(a, labels=a * 2)
        got = [consumer.get(timeout=10) for _ in sent]
    finally:
        pub.close()
        consumer.close()
    for (f, lab), a in zip(got, sent):
        np.testing.assert_array_equal(f, a)
        np.testing.assert_array_equal(lab, a * 2)


def _lenet_batches(n, batch=8, seed=3):
    rng = np.random.RandomState(seed)
    return [DataSet(rng.rand(batch, 784).astype(np.float32),
                    np.eye(10, dtype=np.float32)[rng.randint(0, 10, batch)])
            for _ in range(n)]


def test_streamed_fit_is_bitwise_a_list_fit():
    batches = _lenet_batches(6)
    ref = MultiLayerNetwork(lenet(), device="cpu").init()
    init = {ln: {pn: t.clone() for pn, t in lp.items()}
            for ln, lp in ref.params.items()}
    ref.fit(ListDataSetIterator(batches))
    consumer = streaming.NDArrayConsumer(port=0).listen()
    pub = streaming.NDArrayPublisher("127.0.0.1", consumer.port)
    try:
        for ds in batches:
            for x, y in zip(ds.features, ds.labels):
                pub.publish(x, labels=y)
        it = streaming.StreamingDataSetIterator(
            consumer, batch_size=8, total_batches=len(batches), timeout=10)
        net = MultiLayerNetwork(lenet(), device="cpu").init(params=init)
        net.fit(it)
    finally:
        pub.close()
        consumer.close()
    assert net.iteration_count == ref.iteration_count == 6
    for ln, lp in ref.params.items():
        for pn, t in lp.items():
            assert torch.equal(net.params[ln][pn], t), (ln, pn)


def test_serve_re_exports_the_serving_tier():
    assert streaming.ModelServer is serving.ModelServer
    from deeplearning4j_tpu_torch.serving.server import MAX_BODY
    from deeplearning4j_tpu_torch.streaming.serve import (
        MAX_BODY as STREAM_MAX_BODY,
    )
    assert STREAM_MAX_BODY == MAX_BODY == jstreaming.serve.MAX_BODY


def test_streaming_iterator_rejects_mixed_labels():
    class Src:
        def __init__(self):
            self.items = [(np.zeros(2, np.float32), None),
                          (np.zeros(2, np.float32), np.ones(1, np.float32))]

        def get(self, timeout=None):
            return self.items.pop(0)

    it = streaming.StreamingDataSetIterator(Src(), batch_size=2,
                                            total_batches=1)
    with pytest.raises(ValueError, match="mixes labeled"):
        next(it)
