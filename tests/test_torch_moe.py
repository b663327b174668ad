"""The Switch mixture-of-experts FFN of the port (``parallel/expert.py``,
``nn/layers/moe.py``, ``TransformerBlock(n_experts > 0)``) against the
JAX package on the CPU, on weights carried across from numpy seeds:

- the dense dispatch (routing, capacity drops, the token mask) equal to
  JAX's, and the slot-index dispatch of the main path bitwise the dense
  plain version;
- the MoE FFN and its load-balancing loss against JAX within
  ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5), top-1 routing identical;
- the bf16 position ``cumsum`` pinned to what JAX does past 256 tokens
  an expert (shared slots: a fault of the reference the port follows),
  on the dispatch and through a bf16 ``MixtureOfExperts`` (to bf16
  rounding: one unit in the last place of the output's largest entry);
- ``MixtureOfExperts`` in a ``MultiLayerNetwork`` (output, score,
  gradients, Adam steps);
- a small MoE ``transformer_lm``: output, gradients, three Adam steps of
  ``fit`` (weights at rtol 1e-3, atol 1e-5, as
  ``tests/test_torch_transformer.py`` holds the dense LM, save at most 8
  elements whose gradients lie at the f32 noise floor: Adam moves them
  by up to lr whatever their size) and
  ``rnn_time_step`` against JAX's own (the capacity is per call, so it
  is not ``output``);
- ``ExpertParallelMoE`` on 2 and 4 gloo ranks (subprocesses of torch,
  numpy and the port) against JAX's on as many of the 8 virtual devices
  and against the single-device MoE of each rank's tokens; a world of
  one bitwise the single-device MoE.

Top-1 routing is discontinuous: a last-bit difference can flip a token
whose two best experts tie. Each comparison on random weights first
checks that no token of its data lies within 1e-4 of a tie, so a flip
cannot hide behind the tolerance.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JDenseLayer
from deeplearning4j_tpu.nn.layers import MixtureOfExperts as JMoE
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.parallel import expert as jexpert
from deeplearning4j_tpu.zoo.models import transformer_lm as jax_lm
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import MixtureOfExperts
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import Mesh, expert
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy,
    restore_model,
    write_model,
)
from deeplearning4j_tpu_torch.zoo import transformer_lm

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 180
D, H, E = 8, 16, 4
W_RTOL, W_ATOL = 1e-3, 1e-5
TIE_MARGIN = 1e-4


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, ref, rtol=None, atol=None, err_msg=""):
    krtol, katol = kernel_tols()
    np.testing.assert_allclose(_np(got), np.asarray(ref),
                               rtol=krtol if rtol is None else rtol,
                               atol=katol if atol is None else atol,
                               err_msg=err_msg)


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _moe_params(seed=0, d=D, h=H, e=E):
    """MoE parameters from a numpy seed, with nonzero biases."""
    rng = np.random.RandomState(seed)
    return {"router": (rng.randn(d, e) * 1.5).astype(np.float32),
            "w1": (rng.randn(e, d, h) / np.sqrt(d)).astype(np.float32),
            "b1": (rng.randn(e, h) * 0.1).astype(np.float32),
            "w2": (rng.randn(e, h, d) / np.sqrt(h)).astype(np.float32),
            "b2": (rng.randn(e, d) * 0.1).astype(np.float32)}


def _no_near_ties(logits):
    """The routing of ``logits`` has no top-2 probability gap below
    TIE_MARGIN (a last-bit difference cannot flip it)."""
    p = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(logits), -1)), -1)
    assert (p[:, -1] - p[:, -2]).min() > TIE_MARGIN


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _torch_params(p):
    return {k: _t(v) for k, v in p.items()}


# -- dispatch -------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_dispatch_routing_and_capacity_match_jax(masked):
    rng = np.random.RandomState(1)
    logits = (rng.randn(40, E) * 2).astype(np.float32)
    mask = (rng.rand(40) > 0.3).astype(np.float32) if masked else None
    _no_near_ties(logits)
    cap = 6  # below the 10 a uniform routing needs: tokens drop
    jd, jc, jp = jexpert.switch_dispatch(
        jnp.asarray(logits), cap, None if mask is None else jnp.asarray(mask))
    d, c, p = expert.switch_dispatch(_t(logits), cap,
                                     None if mask is None else _t(mask))
    np.testing.assert_array_equal(_np(d), np.asarray(jd))
    _close(c, jc)
    _close(p, jp)
    assert 0 < _np(d).sum() < 40  # some routed, some dropped
    # the slot form names the same (expert, slot) per token, or the drop
    slot, gate, _ = expert.switch_route(_t(logits), cap,
                                        None if mask is None else _t(mask))
    dense = np.asarray(jd).reshape(40, E * cap)
    want = np.where(dense.any(1), dense.argmax(1), E * cap)
    np.testing.assert_array_equal(_np(slot), want)
    _close(gate, np.asarray(jp).max(-1))


def test_dispatch_token_mask_and_capacity_one():
    logits = _t(np.tile([[5.0, 0.0]], (4, 1)).astype(np.float32))
    d, _, _ = expert.switch_dispatch(logits, 2, _t(np.float32([1, 0, 1, 0])))
    np.testing.assert_array_equal(_np(d.sum((1, 2))), [1, 0, 1, 0])
    d2, _, _ = expert.switch_dispatch(logits, 2)
    np.testing.assert_array_equal(_np(d2.sum((1, 2))), [1, 1, 0, 0])
    d1, _, _ = expert.switch_dispatch(logits, 1)
    assert float(d1.sum()) == 1.0


@pytest.mark.parametrize("masked", [False, True])
def test_slot_dispatch_is_bitwise_the_dense_plain_version(masked):
    rng = np.random.RandomState(2)
    p = _torch_params(_moe_params(2))
    x = _t(rng.randn(64, D).astype(np.float32))
    mask = _t((rng.rand(64) > 0.25).astype(np.float32)) if masked else None
    fast = expert.moe_ffn(p, x, 1.0, mask)
    plain = expert.moe_ffn_reference(p, x, 1.0, mask)
    assert torch.equal(fast, plain)
    assert (fast.abs().sum(1) == 0).any()  # capacity 16 drops tokens
    # and the gradients agree (the sums run in other orders)
    grads = []
    for fn in (expert.moe_ffn, expert.moe_ffn_reference):
        q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xx = x.clone().requires_grad_(True)
        (fn(q, xx, 1.0, mask) ** 2).sum().backward()
        grads.append({**{k: v.grad for k, v in q.items()}, "x": xx.grad})
    for k in grads[0]:
        _close(grads[0][k], _np(grads[1][k]), 1e-5, 1e-6, k)


@pytest.mark.parametrize("masked", [False, True])
def test_moe_ffn_and_aux_loss_match_jax(masked):
    rng = np.random.RandomState(3)
    p = _moe_params(3)
    x = rng.randn(96, D).astype(np.float32)
    mask = (rng.rand(96) > 0.2).astype(np.float32) if masked else None
    _no_near_ties(x @ p["router"])
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    want = jexpert.moe_ffn_reference(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), 1.25, jm)
    _close(expert.moe_ffn(_torch_params(p), _t(x), 1.25, tm), want)
    _close(expert.aux_load_balance_loss(_t(x @ p["router"])),
           jexpert.aux_load_balance_loss(jnp.asarray(x @ p["router"])))
    assert expert.moe_capacity(96, 1.25, E) == 30


def test_bf16_positions_follow_jax_past_256_tokens():
    """JAX builds the position ``cumsum`` in the logits' dtype: in bf16
    it is not exact past 256, so tokens share a slot (the 257th position
    reads 256). The port reproduces the reference's slots bit for bit,
    shared ones included, and sums the tokens of a shared slot as the
    dense ``einsum`` does."""
    n = 700
    logits = np.zeros((n, E), np.float32)
    logits[:, 0] = 3.0
    logits[::7, 1] = 5.0
    logits[::11, 2] = 6.0
    jl = jnp.asarray(logits, jnp.bfloat16)
    jd, _, _ = jexpert.switch_dispatch(jl, 1000)
    jd = np.asarray(jd.astype(jnp.float32))
    tl = _t(logits).to(torch.bfloat16)
    d, _, _ = expert.switch_dispatch(tl, 1000)
    np.testing.assert_array_equal(d.float().numpy(), jd)
    # the fault, pinned: expert 0's 500-odd tokens share slots
    per_slot = jd.sum(0)
    assert per_slot.max() > 1 and (per_slot > 1).sum() > 10
    onehot = np.zeros((n, E), np.float32)
    onehot[np.arange(n), logits.argmax(1)] = 1.0
    jcs = np.asarray(jnp.cumsum(jnp.asarray(onehot, jnp.bfloat16), 0)
                     .astype(jnp.float32))
    exact = np.cumsum(onehot[:, 0])
    assert jcs[np.argmax(exact == 257), 0] == 256.0  # the 257th reads 256
    assert (jcs[:, 0] != exact).sum() > 100
    np.testing.assert_array_equal(
        expert._cumsum_like_xla(_t(onehot).to(torch.bfloat16)).float()
        .numpy(), jcs)
    # the slot path: shared slots summed, as "nd,nec->ecd" sums them
    rng = np.random.RandomState(4)
    x = _t(rng.randn(n, D).astype(np.float32)).to(torch.bfloat16)
    slot, _, _ = expert.switch_route(tl, 1000)
    dense_in = torch.einsum("nd,nec->ecd", x.float(), d.float())
    got = expert.scatter_slots(x.float(), slot, E * 1000).reshape(E, 1000, D)
    assert torch.equal(got, dense_in)


def test_bf16_layer_shares_slots_as_jax_does(monkeypatch):
    """``MixtureOfExperts`` in bf16 (the compute dtype of a
    ``compute_dtype="bfloat16"`` network) with 624 of 700 tokens routed
    to one expert: the port's output is JAX's to bf16 rounding (one unit
    in the last place of the largest entry), while exact positions
    would give 367 rows another output: the shared slots are pinned."""
    rng = np.random.RandomState(11)
    d, h, e, n = 8, 16, 2, 700
    p = _moe_params(11, d=d, h=h, e=e)
    p["router"] = p["router"] * 2.0
    x = rng.randn(n, d).astype(np.float32)
    x[:, 0] += 2.0
    kw = dict(n_in=d, n_out=d, n_experts=e, hidden_size=h,
              capacity_factor=2.0, activation="identity")
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: _t(v).to(torch.bfloat16) for k, v in p.items()}
    jx = jnp.asarray(x, jnp.bfloat16)
    jout = np.asarray(JMoE(**kw).apply(jp, jx, {})[0].astype(jnp.float32))
    layer = MixtureOfExperts(**kw)
    tx = _t(x).to(torch.bfloat16)
    out = layer.apply(tp, tx, {})[0].float().numpy()
    logits = np.asarray((jx @ jp["router"]).astype(jnp.float32))
    assert np.bincount(logits.argmax(1), minlength=e).max() > 600
    ulp = 2.0 ** -7 * np.abs(jout).max()
    np.testing.assert_allclose(out, jout, rtol=0, atol=ulp)

    def exact(onehot):
        csum = torch.cumsum(onehot.double(), 0) * onehot.double()
        return (csum.sum(-1) - 1).float()

    monkeypatch.setattr(expert, "_positions", exact)
    moved = layer.apply(tp, tx, {})[0].float().numpy()
    assert (np.abs(moved - jout).max(1) > 10 * ulp).sum() > 300


# -- the layer in a MultiLayerNetwork ---------------------------------------


def _moe_mln_pair():
    conf = (JNNC.Builder().seed(3).learning_rate(0.02).updater("ADAM")
            .list()
            .layer(JDenseLayer(n_in=6, n_out=8, activation="tanh"))
            .layer(JMoE(n_in=8, n_out=8, n_experts=4, hidden_size=16,
                        activation="identity"))
            .layer(JOutputLayer(n_out=3))
            .build())
    jnet = JMultiLayerNetwork(conf).init()
    rng = np.random.RandomState(0)
    jnet.params["1"]["router"] = jnp.asarray(
        rng.randn(8, 4).astype(np.float32) * 3)
    for k in ("b1", "b2"):
        jnet.params["1"][k] = jnp.asarray(
            rng.randn(*jnet.params["1"][k].shape).astype(np.float32) * 0.1)
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init(
        params=params_from_numpy(_flat(jnet.params), "cpu"))
    return jnet, net


def _blobs(seed):
    rng = np.random.RandomState(seed)
    centers = rng.randn(3, 6) * 2
    x = np.concatenate([centers[i] + rng.randn(20, 6)
                        for i in range(3)]).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.repeat(np.arange(3), 20)]
    return x, y


def test_moe_layer_in_a_multilayer_network_matches_jax(tmp_path):
    jnet, net = _moe_mln_pair()
    assert net.conf.to_dict() == jnet.conf.to_dict()
    assert type(net.conf.layers[1]) is MixtureOfExperts
    x, y = _blobs(1)
    h = np.tanh(x @ np.asarray(jnet.params["0"]["W"])
                + np.asarray(jnet.params["0"]["b"]))
    _no_near_ties(h @ np.asarray(jnet.params["1"]["router"]))
    _close(net.output(x), jnet.output(x))
    _close(net.score(DataSet(x, y)), jnet.score(JDataSet(x, y)), 1e-5, 0)
    for _ in range(3):
        jnet.fit(JDataSet(x, y))
        net.fit(DataSet(x, y))
    _close(net.score_value, float(jnet.score_value), 1e-5, 0)
    for key, ref in _flat(jnet.params).items():
        ln, pn = key.rsplit("/", 1)
        _close(net.params[ln][pn], ref, W_RTOL, W_ATOL, key)
    layer = net.conf.layers[1]
    _close(layer.aux_loss(net.params["1"], _t(h.astype(np.float32))),
           jnet.conf.layers[1].aux_loss(
               {k: jnp.asarray(_np(v)) for k, v in net.params["1"].items()},
               jnp.asarray(h.astype(np.float32))))
    # the checkpoint zip carries router / w1 / b1 / w2 / b2
    write_model(net, tmp_path / "moe.zip")
    back = restore_model(str(tmp_path / "moe.zip"), device="cpu")
    assert set(back.params["1"]) == {"router", "w1", "b1", "w2", "b2"}
    assert torch.equal(back.output(x), net.output(x))


def test_moe_layer_masks_padded_timesteps():
    layer = MixtureOfExperts(n_in=4, n_out=4, n_experts=2, hidden_size=8,
                             activation="identity")
    p = _torch_params(_moe_params(5, d=4, h=8, e=2))
    rng = np.random.RandomState(5)
    x = rng.randn(2, 4, 5).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 0]], np.float32)
    out, _ = layer.apply(p, _t(x), {}, mask=_t(mask))
    jlayer = JMoE(n_in=4, n_out=4, n_experts=2, hidden_size=8,
                  activation="identity")
    jout, _ = jlayer.apply({k: jnp.asarray(_np(v)) for k, v in p.items()},
                           jnp.asarray(x), {}, mask=jnp.asarray(mask))
    _close(out, jout)
    assert np.all(_np(out)[0, :, 3:] == 0.0)


# -- the MoE transformer LM ---------------------------------------------------

VOCAB, DM, LAYERS, HEADS, T, BATCH = 11, 32, 2, 4, 16, 3


def _lm_pair():
    jnet = JMultiLayerNetwork(jax_lm(vocab=VOCAB, d_model=DM,
                                     n_layers=LAYERS, n_heads=HEADS,
                                     n_experts=E)).init()
    rng = np.random.RandomState(0)
    for lp in jnet.params.values():
        for pn in list(lp):
            if pn.startswith(("ln", "b")):
                lp[pn] = lp[pn] + rng.randn(*lp[pn].shape).astype(
                    np.float32) * 0.1
            if pn == "router":
                lp[pn] = lp[pn] * 4.0  # decisive routing
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf, device="cpu").init(
        params=params_from_numpy(_flat(jnet.params), "cpu"))
    return jnet, net


def _lm_batch(seed, t=T):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (BATCH, t + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    return (np.ascontiguousarray(eye[ids[:, :-1]].transpose(0, 2, 1)),
            np.ascontiguousarray(eye[ids[:, 1:]].transpose(0, 2, 1)))


def _lm_router_logits(net, x):
    """Each MoE block's router logits on ``x`` (the port's forward)."""
    acts = net.feed_forward(x)
    out = []
    for i, layer in enumerate(net.conf.layers):
        if getattr(layer, "n_experts", 0):
            from deeplearning4j_tpu_torch.nn.layers.attention import (
                _ATTN_PARAMS,
                _layer_norm,
            )
            p = net.params[str(i)]
            h = acts[i - 1]
            a, _ = layer._attn().apply(
                {k: p[k] for k in _ATTN_PARAMS},
                _layer_norm(h, p["ln1_gamma"], p["ln1_beta"], 1e-5), {})
            h2 = _layer_norm(h + a, p["ln2_gamma"], p["ln2_beta"], 1e-5)
            rows = h2.transpose(1, 2).reshape(-1, h2.shape[1])
            out.append(_np(rows @ p["router"]))
    return out


def test_moe_transformer_lm_builder_matches_jax():
    kw = dict(vocab=256, d_model=768, n_layers=12, n_heads=12,
              learning_rate=3e-4, n_experts=4)
    assert transformer_lm(**kw).to_dict() == jax_lm(**kw).to_dict()


def test_moe_transformer_lm_output_gradients_and_fit_match_jax():
    jnet, net = _lm_pair()
    x, y = _lm_batch(1)
    for logits in _lm_router_logits(net, x):
        _no_near_ties(logits)
    _close(net.output(x), jnet.output(x))

    def jscore(p):
        return jnet._score_pure(p, jnet.state, jnp.asarray(x),
                                jnp.asarray(y), None, None, train=True)[0]

    jgrads = jax.grad(jscore)(jnet.params)

    def score_fn(p, state, xs, ys, mask, fmask, rng):
        return core.sequential_score(net.conf, net.layer_names, p, state,
                                     xs, ys, mask, train=True, fmask=fmask)

    (_, _), grads = core.grad_step(score_fn, net.params, net.state, _t(x),
                                   _t(y), None)
    for key, ref in _flat(jgrads).items():
        ln, pn = key.rsplit("/", 1)
        _close(grads[ln][pn], ref, 1e-3, 1e-6, key)
    for seed in (3, 4, 5):
        x, y = _lm_batch(seed)
        jnet.fit(JDataSet(x, y))
        net.fit(DataSet(x, y))
        _close(net.score_value, float(jnet.score_value), 1e-5, 0)
    past = 0
    for key, ref in _flat(jnet.params).items():
        ln, pn = key.rsplit("/", 1)
        got, ref = _np(net.params[ln][pn]), np.asarray(ref)
        off = np.abs(got - ref) > W_ATOL + W_RTOL * np.abs(ref)
        # Adam moves a weight by up to lr a step whatever its gradient's
        # size: an expert weight that its tokens reach only through a
        # pre-activation near zero has a gradient at the f32 noise floor
        # (Adam's sqrt(v) ~1e-10 against a median ~1e-4), and moves
        # differently in the two packages. Only such elements may stray.
        v = np.asarray(jnet.updater_state[ln][pn][1])
        assert (np.sqrt(v[off]) < 1e-6).all(), key
        past += int(off.sum())
    assert past <= 8, past


def test_moe_transformer_lm_rnn_time_step_matches_jax():
    """KV-cache sampling: each call routes its own tokens with its own
    capacity (here 1 an expert at a batch of 3, so tokens drop), as the
    JAX package's ``rnn_time_step`` does."""
    jnet, net = _lm_pair()
    x, _ = _lm_batch(6)
    jnet.rnn_clear_previous_state()
    net.rnn_clear_previous_state()
    for t in range(6):
        _close(net.rnn_time_step(x[:, :, t]),
               np.asarray(jnet.rnn_time_step(x[:, :, t])), err_msg=str(t))
    _close(net.rnn_time_step(x[:, :, 6:10]),
           np.asarray(jnet.rnn_time_step(x[:, :, 6:10])))


# -- expert parallelism -------------------------------------------------------

_RANK = r"""
import json, sys
import numpy as np
import torch
from deeplearning4j_tpu_torch.parallel import (
    init_distributed, shutdown_distributed)
from deeplearning4j_tpu_torch.parallel.expert import (
    ExpertParallelMoE, build_expert_mesh)

spec = json.loads(sys.argv[1])
init_distributed("file://" + spec["rdv"], spec["world"], spec["rank"],
                 device="cpu", timeout_s=120)
mesh = build_expert_mesh(spec["world"])
data = dict(np.load(spec["data"]))
params = {k: torch.from_numpy(data[k]) for k in
          ("router", "w1", "b1", "w2", "b2")}
out = {}
for cf in spec["cfs"]:
    ep = ExpertParallelMoE(mesh, n_experts=spec["experts"],
                           capacity_factor=cf)
    mine = ep.shard_params(params)
    out[f"apply{cf}"] = ep.apply(mine, data["x"]).numpy()
ep = ExpertParallelMoE(mesh, n_experts=spec["experts"])
mine = ep.shard_params(params)
losses = []
for _ in range(spec["steps"]):
    mine, loss = ep.train_step(mine, data["x"], data["tgt"], lr=0.1,
                               aux_weight=0.01)
    losses.append(float(loss))
out["losses"] = np.asarray(losses)
for k, v in mine.items():
    out["p:" + k] = v.numpy()
np.savez(spec["out"], **out)
shutdown_distributed()
"""


def _run_ranks(tmp_path, world, arrays, cfs, steps):
    run = tmp_path / f"ep{world}"
    run.mkdir()
    np.savez(run / "data.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        spec = dict(rank=r, world=world, rdv=str(run / "rdv"),
                    data=str(run / "data.npz"), out=str(run / f"out{r}.npz"),
                    cfs=list(cfs), steps=steps, experts=E * 2)
        logs.append(run / f"err{r}.txt")
        with open(logs[-1], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK, json.dumps(spec)],
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


@pytest.mark.parametrize("world", [2, 4])
def test_expert_parallel_matches_jax_and_the_single_device_moe(tmp_path,
                                                                world):
    """8 experts over ``world`` ranks, 16 tokens a rank. ``apply`` at
    capacity factor 1.25 (tokens drop, per rank) against JAX's
    ``ExpertParallelMoE`` on ``world`` devices and against the
    single-device MoE of each rank's tokens, and at a capacity factor of
    8 (nothing drops) against the single-device MoE of all tokens;
    three SGD ``train_step``s against JAX's (losses and the sharded
    parameters)."""
    e = E * 2
    p = _moe_params(7, e=e)
    rng = np.random.RandomState(8)
    n = 16 * world
    x = rng.randn(n, D).astype(np.float32)
    tgt = (x @ rng.randn(D, D).astype(np.float32) * 0.1).astype(np.float32)
    _no_near_ties(x @ p["router"])
    results = _run_ranks(tmp_path, world, dict(x=x, tgt=tgt, **p),
                         (1.25, 8.0), steps=3)
    for r in results[1:]:
        for k in ("apply1.25", "apply8.0", "losses"):
            np.testing.assert_array_equal(r[k], results[0][k], err_msg=k)
    mesh = jexpert.build_expert_mesh(world)
    jep = jexpert.ExpertParallelMoE(mesh, n_experts=e, capacity_factor=1.25)
    jp = jep.shard_params({k: jnp.asarray(v) for k, v in p.items()})
    got = results[0]["apply1.25"]
    _close(got, np.asarray(jep.apply(jp, x)))
    per = n // world
    tp = _torch_params(p)
    local = np.concatenate([_np(expert.moe_ffn(
        tp, _t(x[i * per:(i + 1) * per]), 1.25)) for i in range(world)])
    _close(got, local)
    # nothing drops at a capacity factor of E: the whole-batch MoE
    _close(results[0]["apply8.0"], _np(expert.moe_ffn(tp, _t(x), 8.0)))
    losses = []
    for _ in range(3):
        jp, loss = jep.train_step(jp, x, tgt, lr=0.1, aux_weight=0.01)
        losses.append(float(loss))
    _close(results[0]["losses"], np.asarray(losses), 1e-5, 1e-7)
    el = e // world
    for k in ("router", "w1", "b1", "w2", "b2"):
        full = np.asarray(jp[k])
        for r, res in enumerate(results):
            want = full if k == "router" else full[r * el:(r + 1) * el]
            _close(res["p:" + k], want, 1e-4, 1e-6, f"rank {r} {k}")


def test_expert_parallel_world_of_one_is_the_single_device_moe():
    mesh = expert.build_expert_mesh(device="cpu")
    assert mesh.data == 1 and mesh.backend is None
    ep = expert.ExpertParallelMoE(mesh, n_experts=E)
    p = _torch_params(_moe_params(9))
    x = torch.from_numpy(np.random.RandomState(9).randn(40, D).astype(
        np.float32))
    assert torch.equal(ep.apply(ep.shard_params(p), x),
                       expert.moe_ffn(p, x, 1.25))
    with pytest.raises(ValueError, match="divisible"):
        expert.ExpertParallelMoE(Mesh(3, 0, torch.device("cpu"), None),
                                 n_experts=4)
    ep2 = expert.ExpertParallelMoE(Mesh(2, 0, torch.device("cpu"), None),
                                   n_experts=4)
    if not torch.cuda.is_available():  # the card by default, else raise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            expert.build_expert_mesh()
    with pytest.raises(ValueError, match="divisible"):
        ep2.apply(p, x[:9])
