"""The port stands alone: no module of ``deeplearning4j_tpu_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, the package imports
and runs LeNet on the CPU in a fresh process without loading JAX, and
its entry points never fall back to the CPU silently."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import dispatch
from deeplearning4j_tpu_torch.zoo import lenet

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "deeplearning4j_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_fresh_process_runs_lenet_without_jax():
    code = (
        "import sys, numpy as np\n"
        "from deeplearning4j_tpu_torch.nn.multilayer import "
        "MultiLayerNetwork\n"
        "from deeplearning4j_tpu_torch.serving import ModelServer\n"
        "from deeplearning4j_tpu_torch.zoo import lenet\n"
        "net = MultiLayerNetwork(lenet(), device='cpu').init()\n"
        "y = net.output(np.zeros((2, 784), np.float32))\n"
        "assert tuple(y.shape) == (2, 10)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deeplearning4j_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_fresh_process_imports_the_observability_modules_without_jax():
    """The tracer, exporters, runtime telemetry, step profiler and
    profiler listener import and run in a process that loads no JAX."""
    code = (
        "import sys, numpy as np\n"
        "from deeplearning4j_tpu_torch.observability import (\n"
        "    MetricsRegistry, StepProfiler, TelemetryListener, Tracer,\n"
        "    prometheus_text)\n"
        "from deeplearning4j_tpu_torch.optimize.profiler import "
        "ProfilerListener\n"
        "from deeplearning4j_tpu_torch.util.device import "
        "device_cache_budget_bytes\n"
        "reg = MetricsRegistry()\n"
        "prof = StepProfiler(registry=reg, tracer=Tracer(seed=0))\n"
        "prof.begin_step(1)\n"
        "rec = prof.end_step(rows=2)\n"
        "assert rec['step'] == 1 and 'trace_id' in rec\n"
        "TelemetryListener(registry=reg)\n"
        "assert prometheus_text(reg).endswith('\\n')\n"
        "assert device_cache_budget_bytes('cpu') == 4 << 30\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deeplearning4j_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_fresh_process_imports_the_layers_package_first():
    """``nn.layers`` imported before anything else (its base module needs
    ``nn.conf``, whose package imports the layers back): no import
    cycle, and the char-RNN trains a TBPTT chunk on the CPU."""
    code = (
        "import numpy as np\n"
        "from deeplearning4j_tpu_torch.nn.layers import GravesLSTM\n"
        "from deeplearning4j_tpu_torch.nn.multilayer import "
        "MultiLayerNetwork\n"
        "from deeplearning4j_tpu_torch.zoo import graves_lstm_char_rnn\n"
        "net = MultiLayerNetwork(graves_lstm_char_rnn(vocab=5, hidden=4, "
        "tbptt_length=3), device='cpu').init()\n"
        "x = np.eye(5, dtype=np.float32)[np.arange(6) % 5].T[None]\n"
        "net.fit(x, np.roll(x, -1, axis=2))\n"
        "assert net.iteration_count == 2\n"
        "print('ok')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_files_cover_the_transformer_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("parallel/__init__.py", "parallel/sequence.py",
                   "ops/flash_attention.py", "nn/layers/attention.py"):
        assert f"deeplearning4j_tpu_torch/{module}" in names


def test_fresh_process_runs_the_transformer_without_jax():
    code = (
        "import sys, numpy as np\n"
        "from deeplearning4j_tpu_torch.nn.multilayer import "
        "MultiLayerNetwork\n"
        "from deeplearning4j_tpu_torch.zoo import transformer_lm\n"
        "net = MultiLayerNetwork(transformer_lm(vocab=7, d_model=16, "
        "n_layers=1, n_heads=2), device='cpu').init()\n"
        "x = np.eye(7, dtype=np.float32)[np.arange(9) % 7].T[None]\n"
        "net.fit(x, np.roll(x, -1, axis=2))\n"
        "y = net.rnn_time_step(x[:, :, 0])\n"
        "assert tuple(y.shape) == (1, 7)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deeplearning4j_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_files_cover_the_nlp_and_embeddings_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("nlp/tokenization.py", "nlp/vocab.py", "nlp/word2vec.py",
                   "nlp/serializer.py", "nlp/glove.py",
                   "nlp/paragraph_vectors.py", "embeddings/sparse.py",
                   "embeddings/table.py", "embeddings/word2vec.py",
                   "embeddings/deepwalk.py", "graph/api.py", "graph/graph.py",
                   "graph/walks.py", "graph/deepwalk.py"):
        assert f"deeplearning4j_tpu_torch/{module}" in names


@pytest.mark.parametrize("first", ["nlp", "embeddings", "graph"])
def test_fresh_process_runs_the_embeddings_subsystem_without_jax(first):
    """``nlp``, ``embeddings`` and ``graph`` import in a fresh process
    (each one first: no import cycle) without JAX, and a Word2Vec, a
    DeepWalk and a sharded table run on the CPU."""
    code = (
        "import sys, numpy as np\n"
        f"import deeplearning4j_tpu_torch.{first}\n"
        "from deeplearning4j_tpu_torch.nlp import VocabConstructor, "
        "Word2Vec\n"
        "from deeplearning4j_tpu_torch.graph import DeepWalk, Graph\n"
        "from deeplearning4j_tpu_torch.embeddings import "
        "ShardedEmbeddingTable, ShardedWord2Vec\n"
        "s = [['a', 'b', 'c', 'a', 'd']] * 20\n"
        "c = VocabConstructor(1).build_vocab_from_tokens(s)\n"
        "ids = [np.asarray([c.index_of(w) for w in x]) for x in s]\n"
        "w = Word2Vec(c, ids, layer_size=4, batch_size=16, device='cpu')\n"
        "w.device_epoch_gen = True\n"
        "w.fit()\n"
        "assert len(w.words_nearest('a', 2)) == 2\n"
        "g = Graph(4)\n"
        "[g.add_edge(i, (i + 1) % 4) for i in range(4)]\n"
        "d = DeepWalk(vector_size=4, batch_size=8, device='cpu')\n"
        "d.fit(g, walk_length=4)\n"
        "t = ShardedEmbeddingTable(5, 3, device='cpu')\n"
        "assert t.lookup(np.array([1, 4])).shape == (2, 3)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deeplearning4j_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_embeddings_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from deeplearning4j_tpu_torch.embeddings import ShardedEmbeddingTable
    from deeplearning4j_tpu_torch.graph import DeepWalk
    from deeplearning4j_tpu_torch.nlp import Glove, VocabConstructor, Word2Vec

    cache = VocabConstructor(1).build_vocab_from_tokens([["a", "b"]])
    for make in (lambda: Word2Vec(cache, [[0, 1]]), lambda: DeepWalk(),
                 lambda: Glove(cache, [[0, 1]]),
                 lambda: ShardedEmbeddingTable(3, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiLayerNetwork(lenet())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch.resolve_device("cuda:0")
    assert dispatch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        dispatch.resolve_device("meta")


def test_kernel_routing_follows_the_tensor_device():
    assert dispatch.is_kernel_tensor(torch.zeros(1)) is False
    with pytest.raises(ValueError, match="no kernel or plain version"):
        dispatch.is_kernel_tensor(torch.zeros(1, device="meta"))


def test_cpu_forward_launches_no_kernel():
    dispatch.reset_launch_counts()
    net = MultiLayerNetwork(lenet(dense_width=16), device="cpu").init()
    net.output(torch.zeros(1, 784))
    assert dispatch.launch_counts() == {
        "conv_block": 0, "conv_bwd_data": 0, "conv_bwd_w": 0,
        "matmul_block": 0, "lstm_cell": 0, "lstm_seq_fwd": 0,
        "lstm_seq_bwd": 0, "flash_attention": 0,
        "flash_attention_streamed": 0, "matmul_block_residual": 0}


def test_fresh_process_serves_a_graph_with_the_serving_slice_without_jax(
        tmp_path):
    """The serving slice's modules (``compile/``, the registry, the
    router, the shape record) import and serve a ComputationGraph tenant
    beside a MultiLayerNetwork, with paging, in a process that loads no
    JAX."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("compile/__init__.py", "compile/aot.py",
                   "compile/persistent.py", "serving/compile_cache.py",
                   "serving/registry.py", "serving/router.py",
                   "nn/engine_api.py"):
        assert f"deeplearning4j_tpu_torch/{module}" in names
    code = (
        "import sys, numpy as np\n"
        "from deeplearning4j_tpu_torch.compile import aot, persistent\n"
        "from deeplearning4j_tpu_torch.nn.graph import ComputationGraph\n"
        "from deeplearning4j_tpu_torch.nn.multilayer import "
        "MultiLayerNetwork\n"
        "from deeplearning4j_tpu_torch.serving import ModelServer, "
        "ServingRouter\n"
        "from deeplearning4j_tpu_torch.zoo import lenet, resnet50\n"
        "g = ComputationGraph(resnet50(height=8, width=8, channels=1, "
        "n_classes=3, cifar_stem=True, depths=(1, 1), base_width=4), "
        "device='cpu').init()\n"
        "m = MultiLayerNetwork(lenet(), device='cpu').init()\n"
        "s = ModelServer(models={'g': g, 'm': m}, device='cpu', "
        "max_device_models=1, compile_cache=sys.argv[1], "
        "transform=lambda f: f.reshape(-1, 1, 8, 8) if f.shape[-1] == 64 "
        "else f).start()\n"
        "for name, w in (('g', 64), ('m', 784), ('g', 64)):\n"
        "    code, body, _ = s.submit(np.ones((2, w), np.float32), "
        "model=name)\n"
        "    assert code == 200, body\n"
        "assert s.model_registry.stats()['weight_pagein_total'] >= 2\n"
        "s.stop()\n"
        "assert aot.unpack_artifact(aot.pack_artifact({'a': 1}, b'x')) "
        "== ({'a': 1}, b'x')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deeplearning4j_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_files_cover_the_loop_eval_and_earlystopping_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("loop/__init__.py", "loop/journal.py", "loop/shadow.py",
                   "loop/trainer.py", "loop/promoter.py", "eval/__init__.py",
                   "eval/evaluation.py", "eval/roc.py",
                   "earlystopping/__init__.py", "earlystopping/core.py"):
        assert f"deeplearning4j_tpu_torch/{module}" in names


@pytest.mark.parametrize("first", ["loop", "eval", "earlystopping"])
def test_fresh_process_runs_the_loop_eval_and_earlystopping_without_jax(
        first):
    """``loop``, ``eval`` and ``earlystopping`` import in a fresh process
    (each one first: no import cycle) without JAX; a continual trainer
    publishes, a shadow scorer mirrors, LeNet evaluates and an
    early-stopping fit runs on the CPU."""
    code = (
        "import sys, tempfile, numpy as np\n"
        f"import deeplearning4j_tpu_torch.{first}\n"
        "from deeplearning4j_tpu_torch.datasets import DataSet\n"
        "from deeplearning4j_tpu_torch.earlystopping import (\n"
        "    DataSetLossCalculator, EarlyStoppingConfiguration,\n"
        "    EarlyStoppingTrainer, MaxEpochsTerminationCondition)\n"
        "from deeplearning4j_tpu_torch.loop import (\n"
        "    ContinualTrainer, PromotionJournal, ShadowScorer)\n"
        "from deeplearning4j_tpu_torch.nn.multilayer import "
        "MultiLayerNetwork\n"
        "from deeplearning4j_tpu_torch.resilience.checkpoint import "
        "CheckpointManager\n"
        "from deeplearning4j_tpu_torch.zoo import lenet\n"
        "net = MultiLayerNetwork(lenet(dense_width=8), device='cpu').init()\n"
        "x = np.random.RandomState(0).rand(4, 784).astype(np.float32)\n"
        "ds = DataSet(x, np.eye(10, dtype=np.float32)[[0, 1, 2, 3]])\n"
        "d = tempfile.mkdtemp()\n"
        "j = PromotionJournal(d + '/j.json')\n"
        "ct = ContinualTrainer(net, CheckpointManager(d + '/c'), "
        "publish_every=1, journal=j)\n"
        "assert ct.run([ds]) == 1 and ct.manager.list_steps() == [1]\n"
        "sc = ShadowScorer(net.copy())\n"
        "sc.observe(x, net.output(x))\n"
        "assert sc.snapshot()['agreement'] == 1.0\n"
        "assert net.evaluate([ds]).confusion.total() == 4\n"
        "cfg = EarlyStoppingConfiguration(DataSetLossCalculator([ds]), "
        "[MaxEpochsTerminationCondition(2)])\n"
        "assert EarlyStoppingTrainer(cfg, net, [ds]).fit().total_epochs "
        "== 2\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deeplearning4j_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_files_cover_the_clustering_and_nlp_periphery_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("clustering/__init__.py", "clustering/vptree.py",
                   "clustering/kdtree.py", "clustering/cluster.py",
                   "clustering/kmeans.py", "nlp/model_utils.py",
                   "nlp/static_word2vec.py", "nlp/vectorizers.py",
                   "nlp/inverted_index.py", "graph/loader.py",
                   "graph/serializer.py", "parallel/cluster_nlp.py",
                   "parallel/row_exchange.py"):
        assert f"deeplearning4j_tpu_torch/{module}" in names


@pytest.mark.parametrize("first", ["clustering", "parallel.cluster_nlp",
                                   "nlp.model_utils", "graph.serializer"])
def test_fresh_process_runs_the_periphery_without_jax(first):
    """``clustering``, the cluster NLP trainers, the model utilities and
    the graph serializer import first in a fresh process (no import
    cycle) without JAX, and k-means, a cluster Word2Vec of one rank, the
    VP-tree nearest words, TF-IDF and the inverted index run on the
    CPU."""
    code = (
        "import sys, numpy as np\n"
        f"import deeplearning4j_tpu_torch.{first}\n"
        "from deeplearning4j_tpu_torch.clustering import KMeansClustering\n"
        "from deeplearning4j_tpu_torch.nlp import (InvertedIndex, "
        "TfidfVectorizer, TreeModelUtils)\n"
        "from deeplearning4j_tpu_torch.parallel import ClusterWord2Vec, "
        "TextPipeline\n"
        "x = np.random.RandomState(0).randn(40, 3).astype(np.float32)\n"
        "cs = KMeansClustering.setup(3, 5, device='cpu').apply_to(x)\n"
        "assert cs.get_cluster_count() == 3\n"
        "s = ['a b c a d'] * 20\n"
        "tp = TextPipeline()\n"
        "c = tp.build_vocab(s)\n"
        "w = ClusterWord2Vec(c, tp.to_id_sequences(s, c), layer_size=4, "
        "batch_size=16, device='cpu')\n"
        "w.fit()\n"
        "assert len(TreeModelUtils(w).words_nearest('a', 2)) == 2\n"
        "v = TfidfVectorizer(device='cpu')\n"
        "v.fit([(t, 'x') for t in s])\n"
        "assert tuple(v.vectorize('a b', 'x').features.shape) == (1, 4)\n"
        "ix = InvertedIndex()\n"
        "ix.add_doc(['a', 'b'])\n"
        "assert ix.documents('a') == [0]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deeplearning4j_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_files_cover_the_moe_parsers_and_networks_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("nn/layers/moe.py", "parallel/expert.py",
                   "nlp/treeparser.py", "nlp/pos_tagger.py", "nlp/cjk.py",
                   "nlp/japanese.py", "nn/conf/preprocessors.py",
                   "zoo/models.py"):
        assert f"deeplearning4j_tpu_torch/{module}" in names


@pytest.mark.parametrize("first", ["parallel.expert", "nn.layers.moe",
                                   "nlp.japanese", "nlp.treeparser"])
def test_fresh_process_runs_the_moe_and_parsers_without_jax(first):
    """The MoE modules and the parsers import first in a fresh process
    (no import cycle) without JAX; a MoE transformer LM and a GoogLeNet
    graph build, the expert-parallel runtime and graph ``rnn_time_step``
    run on the CPU, and the Japanese lattice segments."""
    code = (
        "import sys, numpy as np, torch\n"
        f"import deeplearning4j_tpu_torch.{first}\n"
        "from deeplearning4j_tpu_torch.nn.graph import ComputationGraph\n"
        "from deeplearning4j_tpu_torch.nn.multilayer import "
        "MultiLayerNetwork\n"
        "from deeplearning4j_tpu_torch.parallel import expert\n"
        "from deeplearning4j_tpu_torch.zoo import googlenet, transformer_lm\n"
        "from deeplearning4j_tpu_torch.nlp import tokenizer_factory, "
        "TreeParser\n"
        "net = MultiLayerNetwork(transformer_lm(vocab=8, d_model=16, "
        "n_layers=1, n_heads=2, n_experts=2), device='cpu').init()\n"
        "x = np.eye(8, dtype=np.float32)[[1, 2, 3]].T[None]\n"
        "assert tuple(net.output(x).shape) == (1, 8, 3)\n"
        "assert tuple(net.rnn_time_step(x[:, :, 0]).shape) == (1, 8)\n"
        "g = ComputationGraph(googlenet(height=32, width=32, n_classes=3), "
        "device='cpu').init()\n"
        "assert g.num_params() > 5e6\n"
        "ep = expert.ExpertParallelMoE(expert.build_expert_mesh("
        "device='cpu'), 2)\n"
        "p = expert.init_moe_params(torch.Generator(), 4, 8, 2)\n"
        "assert tuple(ep.apply(ep.shard_params(p), torch.randn(6, 4))"
        ".shape) == (6, 4)\n"
        "toks = tokenizer_factory('japanese').create('すもももももももものうち')"
        ".get_tokens()\n"
        "assert toks[0] == 'すもも', toks\n"
        "assert TreeParser().parse('The dog ran').label == 'S'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deeplearning4j_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_new_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import googlenet, transformer_lm

    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiLayerNetwork(transformer_lm(n_experts=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ComputationGraph(googlenet())


def test_port_files_cover_the_tuning_import_and_reader_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("ops/tiling.py", "ops/autotune.py", "modelimport/keras.py",
                "modelimport/__init__.py", "util/model_guesser.py",
                "util/flops.py", "datasets/record_reader.py",
                "datasets/iris.py", "datasets/curves.py",
                "datasets/realdata.py", "datasets/lfw.py"):
        assert f"deeplearning4j_tpu_torch/{mod}" in names


def test_fresh_process_imports_every_module_without_h5py_pil_or_sklearn():
    """h5py, PIL and scikit-learn are imported inside the functions that
    read their files (the card's machine has none of them): every module
    of the package imports with the three blocked, and without JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for m in ('h5py', 'PIL', 'sklearn'):\n"
        "    sys.modules[m] = None\n"
        "import deeplearning4j_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from deeplearning4j_tpu_torch.modelimport import "
        "import_sequential_model_arrays\n"
        "import json, numpy as np\n"
        "cfg = json.dumps({'class_name': 'Sequential', 'config': [\n"
        "    {'class_name': 'Dense', 'config': {'name': 'd', "
        "'output_dim': 2, 'activation': 'softmax', "
        "'batch_input_shape': [None, 3]}}]})\n"
        "net = import_sequential_model_arrays(cfg, {'d': {'W': "
        "np.ones((3, 2), np.float32), 'b': np.zeros(2, np.float32)}}, "
        "device='cpu')\n"
        "assert tuple(net.output(np.ones((1, 3), np.float32)).shape) == "
        "(1, 2)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'jaxlib', 'deeplearning4j_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_port_covers_every_module_of_the_jax_package():
    """Each Python module and C++ source of the JAX package has a
    counterpart at the same path in the port, but JAX's
    ``parallel/compat.py`` (a ``shard_map`` version shim for jax)."""
    def files(pkg):
        root = ROOT / pkg
        return {str(p.relative_to(root)) for ext in ("*.py", "*.cpp")
                for p in root.rglob(ext) if "__pycache__" not in p.parts}

    missing = files("deeplearning4j_tpu") - files("deeplearning4j_tpu_torch")
    assert missing == {"parallel/compat.py"}
