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
        "matmul_block": 0}
