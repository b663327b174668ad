"""The transformer-LM slice as a whole, against the JAX package on the
CPU: ``zoo.transformer_lm`` at vocab 11, d_model 32, 2 layers, 4 heads
(head dimension 8), t 16, batch 3, built by the JAX package and carried
into the port through its ``configuration.json`` and
``params_from_numpy``.

- ``output``, ``score`` and the gradients on the same weights, with and
  without a features mask;
- three Adam steps of ``fit``: scores, weights and the Adam moments;
- ``rnn_time_step`` (the KV-cache decode) against ``output``, and the
  streaming contract (cache overflow, non-causal blocks, the carry
  surviving ``fit``'s reset);
- the configuration round trip in both directions, the Builder's
  transform hints, the MoE option loading and the refused
  ring-attention option;
- GELU (tanh) and LayerNorm (population variance over axis 1) pinned
  against JAX;
- a JAX checkpoint restoring, Adam state included, and resuming.

JAX runs its default CPU route (the reference attention; XLA dense);
the port's CPU route is each kernel's plain version. Forward
tolerances: ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5). Adam moves
every weight by about lr (1e-3) a step whatever its gradient's size, so
a gradient at the f32 noise floor can move differently in the two
packages: the weights after three steps are held at rtol 1e-3, atol
1e-5 (1 % of lr), the scores at rtol 1e-5.
"""

import json
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf.multi_layer import (
    MultiLayerConfiguration as JMultiLayerConfiguration,
)
from deeplearning4j_tpu.nn.layers import (
    LayerNormalization as JLayerNormalization,
)
from deeplearning4j_tpu.nn.layers import TransformerBlock as JTransformerBlock
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu.zoo.models import transformer_lm as jax_lm
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import activations, core
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import (
    LayerNormalization,
    MultiHeadSelfAttention,
    RnnOutputLayer,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.nn.layers.attention import _layer_norm
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import dispatch
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy,
    restore_model,
    updater_state_from_numpy,
    write_model,
)
from deeplearning4j_tpu_torch.zoo import transformer_lm

VOCAB, D, LAYERS, HEADS, T, BATCH = 11, 32, 2, 4, 16, 3
W_RTOL, W_ATOL = 1e-3, 1e-5


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _flat_updater(state):
    return {f"{ln}/{pn}/{i}": np.asarray(a)
            for ln, lp in state.items() for pn, tup in lp.items()
            for i, a in enumerate(tup)}


def _pair(**kw):
    """The JAX network (non-trivial norm and bias parameters, so every
    parameter shapes the output) and the port's twin on its weights,
    built from its configuration's JSON."""
    jnet = JMultiLayerNetwork(jax_lm(vocab=VOCAB, d_model=D, n_layers=LAYERS,
                                     n_heads=HEADS, **kw)).init()
    rng = np.random.RandomState(0)
    for lp in jnet.params.values():
        for pn in list(lp):
            if pn.startswith(("ln", "b")):
                lp[pn] = lp[pn] + rng.randn(*lp[pn].shape).astype(
                    np.float32) * 0.1
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf, device="cpu").init(
        params=params_from_numpy(_flat(jnet.params), "cpu"))
    return jnet, net


def _batch(seed, t=T, masked=False):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (BATCH, t + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    x = np.ascontiguousarray(eye[ids[:, :-1]].transpose(0, 2, 1))
    y = np.ascontiguousarray(eye[ids[:, 1:]].transpose(0, 2, 1))
    mask = None
    if masked:
        mask = np.ones((BATCH, t), np.float32)
        mask[0, t // 2:] = 0.0
        mask[2, 3:] = 0.0
    return x, y, mask


def _close(got, ref, rtol=None, atol=None, err_msg=""):
    krtol, katol = kernel_tols()
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref),
                               rtol=krtol if rtol is None else rtol,
                               atol=katol if atol is None else atol,
                               err_msg=err_msg)


def test_zoo_builder_matches_jax():
    for kw in (dict(vocab=256, d_model=768, n_layers=12, n_heads=12,
                    learning_rate=3e-4), dict()):
        assert transformer_lm(**kw).to_dict() == jax_lm(**kw).to_dict()


def test_configuration_round_trips_both_ways():
    conf = transformer_lm(vocab=VOCAB, d_model=D, n_layers=LAYERS,
                          n_heads=HEADS)
    via_jax = JMultiLayerConfiguration.from_json(conf.to_json())
    assert via_jax.to_dict() == conf.to_dict()
    back = MultiLayerConfiguration.from_json(via_jax.to_json())
    assert back == conf
    kinds = [type(l).__name__ for l in back.layers]
    assert kinds == (["DenseLayer", "PositionalEncoding"]
                     + ["TransformerBlock"] * LAYERS + ["RnnOutputLayer"])
    assert json.loads(conf.to_json())["layers"][2]["kv_cache"] == 1024


@pytest.mark.parametrize("masked", [False, True])
def test_output_and_score_match_jax(masked):
    jnet, net = _pair()
    x, y, mask = _batch(1, masked=masked)
    dispatch.reset_launch_counts()
    jm = None if mask is None else jnp.asarray(mask)
    _close(net.output(x, features_mask=mask),
           jnet.output(x, features_mask=jm))
    ds, jds = (DataSet(x, y, features_mask=mask),
               JDataSet(x, y, features_mask=mask))
    _close(net.score(ds), jnet.score(jds), rtol=1e-5, atol=0)
    assert sum(dispatch.launch_counts().values()) == 0  # the plain route


def test_gradients_match_jax():
    jnet, net = _pair()
    x, y, _ = _batch(2)

    def jscore(p):
        return jnet._score_pure(p, jnet.state, jnp.asarray(x), jnp.asarray(y),
                                None, None, train=True)[0]

    jgrads = jax.grad(jscore)(jnet.params)

    def score_fn(p, state, xs, ys, mask, fmask, rng):
        return core.sequential_score(net.conf, net.layer_names, p, state, xs,
                                     ys, mask, train=True, fmask=fmask)

    (_, _), grads = core.grad_step(score_fn, net.params, net.state,
                                   torch.from_numpy(x), torch.from_numpy(y),
                                   None)
    for key, ref in _flat(jgrads).items():
        ln, pn = key.rsplit("/", 1)
        _close(grads[ln][pn], ref, 1e-3, 1e-6, key)


@pytest.mark.parametrize("masked", [False, True])
def test_adam_fit_matches_jax(masked):
    jnet, net = _pair()
    for seed in (3, 4, 5):
        x, y, mask = _batch(seed, masked=masked)
        jnet.fit(JDataSet(x, y, features_mask=mask))
        net.fit(DataSet(x, y, features_mask=mask))
        _close(net.score_value, float(jnet.score_value), rtol=1e-5, atol=0)
    assert net.iteration_count == jnet.iteration_count == 3
    for key, ref in _flat(jnet.params).items():
        ln, pn = key.rsplit("/", 1)
        _close(net.params[ln][pn], ref, W_RTOL, W_ATOL, key)
    for key, ref in _flat_updater(jnet.updater_state).items():
        ln, pn, i = key.rsplit("/", 2)
        _close(net.updater_state[ln][pn][int(i)], ref, W_RTOL, 1e-7, key)


def test_rnn_time_step_matches_output():
    jnet, net = _pair()
    x, _, _ = _batch(6)
    full = net.output(x)
    steps = torch.stack([net.rnn_time_step(x[:, :, t]) for t in range(T)],
                        dim=2)
    _close(steps, full)
    # a chunk at once continues the same stream
    net.rnn_clear_previous_state()
    head = net.rnn_time_step(x[:, :, :5])
    tail = net.rnn_time_step(x[:, :, 5:])
    _close(torch.cat([head, tail], dim=2), full)
    jnet.rnn_clear_previous_state()
    _close(head, np.asarray(jnet.rnn_time_step(x[:, :, :5])))
    # the carry: a cache per block, the position of the encoding
    pos = {name: st["pos"] for name, st in net._rnn_state.items()}
    assert set(pos.values()) == {T}
    assert net._rnn_state["2"]["k_cache"].shape == (BATCH, HEADS, 1024,
                                                    D // HEADS)


def test_streaming_survives_fit_and_restarts_when_cleared():
    _, net = _pair()
    x, y, _ = _batch(7)
    full = net.output(x)
    net.rnn_time_step(x[:, :, :4])
    # fit's reset of the recurrent carry leaves the stream's caches
    net._reset_recurrent_state()
    _close(net.rnn_time_step(x[:, :, 4:])[:, :, -1], full[:, :, -1])
    net.rnn_clear_previous_state()
    _close(net.rnn_time_step(x[:, :, 0]), full[:, :, 0])
    caches = {n: st["k_cache"] for n, st in net._rnn_state.items()
              if "k_cache" in st}
    assert len(caches) == LAYERS
    net.fit(DataSet(x, y))
    assert all(net._rnn_state[n]["k_cache"] is c for n, c in caches.items())
    assert net._stream_steps == 1


def test_kv_cache_overflow_raises():
    jnet, _ = _pair()
    d = jnet.conf.to_dict()
    for layer in d["layers"]:
        if layer["@class"] == "TransformerBlock":
            layer["kv_cache"] = 8
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(d),
                            device="cpu").init()
    x, _, _ = _batch(8)
    net.rnn_time_step(x[:, :, :6])
    with pytest.raises(ValueError, match="overflow"):
        net.rnn_time_step(x[:, :, 6:9])
    net.rnn_time_step(x[:, :, 6:8])  # exactly full
    with pytest.raises(ValueError, match="overflow"):
        net.rnn_time_step(x[:, :, 8])
    block = net.conf.layers[2]
    state = block.init_stream_state(BATCH, torch.float32)
    state["pos"] = 7
    with pytest.raises(ValueError, match="KV cache overflow"):
        block.apply(net.params["2"], torch.zeros(BATCH, D, 2), state)


def test_non_causal_block_refuses_to_stream():
    conf = (NeuralNetConfiguration.Builder().list()
            .layer(TransformerBlock(n_in=8, n_heads=2, causal=False))
            .layer(RnnOutputLayer(n_out=3)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="rnn_time_step"):
        net.rnn_time_step(np.zeros((1, 8), np.float32))
    assert not MultiHeadSelfAttention(n_in=8, n_heads=2).can_stream()
    assert MultiHeadSelfAttention(n_in=8, n_heads=2,
                                  causal=True).can_stream()


def test_builder_transform_hints():
    b = NeuralNetConfiguration.Builder()
    assert b.scan_layers(False).remat("none").loss_scale(None) is b
    assert b.loss_scale(0) is b
    for call in (lambda: b.scan_layers(), lambda: b.scan_layers(True),
                 lambda: b.remat("full"), lambda: b.remat(),
                 lambda: b.loss_scale(1024.0), lambda: b.loss_scale()):
        assert call() is b
    with pytest.raises(ValueError, match="remat policy"):
        b.remat("everything")
    conf = transformer_lm(scan_layers=True, remat="dots_saveable",
                          loss_scale=1024.0)
    assert (conf.scan_layers, conf.remat, conf.loss_scale) == (
        True, "dots_saveable", 1024.0)
    # the hints stay out of configuration.json, as in the JAX package
    for key in ("scan_layers", "remat", "loss_scale"):
        assert key not in conf.to_dict()


def test_moe_and_ring_attention_raise():
    """The MoE option is ported (``tests/test_torch_moe.py`` holds it
    against JAX): it builds, and a JAX MoE configuration loads. Ring
    attention is ported too (``tests/test_torch_sequence_parallel.py``):
    a layer with a seq axis builds, and raises at its forward without
    the seq mesh of ``build_seq_mesh``."""
    TransformerBlock(n_in=8, n_experts=4)
    assert transformer_lm(n_experts=2).layers[2].n_experts == 2
    jconf = jax_lm(vocab=VOCAB, d_model=D, n_layers=1, n_heads=HEADS,
                   n_experts=2)
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert conf.to_dict() == jconf.to_dict()
    params = MultiLayerNetwork(conf, device="cpu").init().params["2"]
    assert {"router", "w1", "b1", "w2", "b2"} <= set(params)
    assert not any(k.startswith(("w_ff", "b_ff")) for k in params)
    from deeplearning4j_tpu_torch.parallel import sequence

    installed = sequence._installed["mesh"]
    sequence._installed["mesh"] = None
    try:
        for cls in (TransformerBlock, MultiHeadSelfAttention):
            layer = cls(n_in=8, n_out=8, n_heads=2, seq_axis="seq",
                        seq_axis_size=4)
            params = layer.init_params(torch.Generator().manual_seed(0))
            with pytest.raises(RuntimeError, match="build_seq_mesh"):
                layer.apply(params, torch.zeros(2, 8, 4), {})
    finally:
        sequence._installed["mesh"] = installed
    # a one-device axis is local attention, as in the JAX layer
    TransformerBlock(n_in=8, seq_axis="seq", seq_axis_size=1)


def test_gelu_and_layer_norm_pinned_to_jax():
    rng = np.random.RandomState(9)
    z = (rng.randn(200) * 3).astype(np.float32)
    _close(activations.get("gelu")(torch.from_numpy(z)),
           jax.nn.gelu(jnp.asarray(z)))
    assert not np.allclose(
        torch.nn.functional.gelu(torch.from_numpy(z)).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(z))), rtol=1e-5, atol=1e-6)
    x = (rng.randn(3, 6, 5) * 2 + 1).astype(np.float32)
    g = rng.randn(6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    jblock = JTransformerBlock(n_in=6, n_heads=2)
    ref = jblock._layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = _layer_norm(*(torch.from_numpy(a) for a in (x, g, b)), 1e-5)
    _close(got, ref)
    # axis 1 with the population variance, not the last axis
    xt = torch.from_numpy(x)
    ln = torch.nn.functional.layer_norm(xt.transpose(1, 2), (6,), eps=1e-5)
    _close(got, (ln * torch.from_numpy(g) + torch.from_numpy(b))
           .transpose(1, 2), 1e-4, 1e-5)
    for shape in ((4, 6), (3, 6, 5)):
        xa = rng.randn(*shape).astype(np.float32)
        params = {"gamma": g, "beta": b}
        jy, _ = JLayerNormalization(n_out=6).apply(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(xa),
            {})
        y, _ = LayerNormalization(n_out=6).apply(
            {k: torch.from_numpy(v) for k, v in params.items()},
            torch.from_numpy(xa), {})
        _close(y, jy)


def test_block_alone_matches_jax_and_fuses_the_ffn_residual(monkeypatch):
    """One TransformerBlock on carried parameters; the FFN's second
    product runs as one residual matmul_block call (its plain version
    here), and under a mask as two plain steps."""
    import importlib

    attn_mod = importlib.import_module(
        "deeplearning4j_tpu_torch.nn.layers.attention")
    calls = []
    real = attn_mod.matmul_block

    def spy(*args, **kw):
        calls.append(args[3].shape)
        return real(*args, **kw)

    monkeypatch.setattr(attn_mod, "matmul_block", spy)
    jblock = JTransformerBlock(n_in=D, n_out=D, n_heads=HEADS)
    jp = jblock.init_params(jax.random.PRNGKey(3))
    block = TransformerBlock(n_in=D, n_out=D, n_heads=HEADS)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x, _, mask = _batch(10, masked=True)
    x = np.random.RandomState(11).randn(BATCH, D, T).astype(np.float32)
    for m in (None, mask):
        jy, _ = jblock.apply(jp, jnp.asarray(x), {},
                             mask=None if m is None else jnp.asarray(m))
        y, _ = block.apply(p, torch.from_numpy(x), {},
                           mask=None if m is None else torch.from_numpy(m))
        _close(y, jy)
    assert calls == [torch.Size([BATCH * T, D])]


def test_jax_checkpoint_restores_with_adam_state_and_resumes():
    jnet, _ = _pair()
    x, y, _ = _batch(12)
    jnet.fit(JDataSet(x, y))
    x2, y2, _ = _batch(13)
    with tempfile.TemporaryDirectory() as d:
        j_zip, p_zip = Path(d) / "jax.zip", Path(d) / "port.zip"
        jax_serializer.write_model(jnet, j_zip)
        net = restore_model(j_zip, device="cpu")
        write_model(net, p_zip)
        back = jax_serializer.restore_model(str(p_zip))
    assert net.iteration_count == back.iteration_count == 1
    _close(net.output(x2), jnet.output(x2))
    for key, ref in _flat_updater(jnet.updater_state).items():
        ln, pn, i = key.rsplit("/", 2)
        _close(net.updater_state[ln][pn][int(i)], ref, 0, 0, key)
    # the bridge without a zip: weights and moments carried by hand
    twin = MultiLayerNetwork(net.conf, device="cpu").init(
        params=params_from_numpy(_flat(jnet.params), "cpu"))
    twin.updater_state = updater_state_from_numpy(
        _flat_updater(jnet.updater_state), twin.updater_state)
    twin.iteration_count = jnet.iteration_count
    # each resumes Adam where JAX left off
    jnet.fit(JDataSet(x2, y2))
    back.fit(JDataSet(x2, y2))
    for model in (net, twin):
        model.fit(DataSet(x2, y2))
        _close(model.score_value, float(jnet.score_value), rtol=1e-5, atol=0)
        for key, ref in _flat(jnet.params).items():
            ln, pn = key.rsplit("/", 1)
            _close(model.params[ln][pn], ref, W_RTOL, W_ATOL, key)
    for key, ref in _flat(back.params).items():
        _close(ref, _flat(jnet.params)[key], W_RTOL, W_ATOL, key)


def test_output_layer_head_sees_every_position():
    """The softmax head is per position over the vocabulary: each
    column of the output sums to one, and a longer input leaves the
    earlier positions' outputs as they were (causality end to end)."""
    _, net = _pair()
    x, _, _ = _batch(14, t=24)
    out = net.output(x)
    _close(out.sum(dim=1), np.ones((BATCH, 24), np.float32), 1e-5, 1e-5)
    _close(net.output(x[:, :, :16]), out[:, :, :16])
    assert isinstance(net.conf.layers[-1], RnnOutputLayer)
