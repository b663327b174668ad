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
