"""A gloo world of the port's ranks for the multi-rank tests (on the
CPU: ``tests/test_torch_{tensor_parallel,sequence_parallel,
pipeline}.py``; on one card, with ``device="cuda"`` and
``backend="gloo"`` in the spec: ``tests/test_torch_cuda.py``): one
subprocess a rank, importing only torch, numpy and the port, the ranks
formed through a file rendezvous in a temporary
directory (never a fixed TCP port: the suite runs on several workers at
once). A module starts its world once (``RankWorld.start``), works on
the JAX side while the ranks run, and reads each rank's ``.npz``
results (``wait``). A world past its timeout is killed and the test
fails with the ranks' stderr, so a hung collective cannot eat the
suite's clock.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent

# the preamble every rank script runs: the spec (argv[1]) and the world
PREAMBLE = r"""
import json, sys
import numpy as np
import torch
from deeplearning4j_tpu_torch.parallel import (
    init_distributed, shutdown_distributed)

spec = json.loads(sys.argv[1])
RANK, WORLD = spec["rank"], spec["world"]
DEVICE = spec.get("device", "cpu")
init_distributed("file://" + spec["rdv"], WORLD, RANK, device=DEVICE,
                 backend=spec.get("backend"), timeout_s=120)
OUT = {}


def save():
    np.savez(spec["out"], **OUT)
"""


class RankWorld:
    """``world`` ranks running ``PREAMBLE + script`` with ``spec``."""

    def __init__(self, run_dir: Path, world: int, procs, logs, timeout_s):
        self.run_dir, self.world = run_dir, world
        self.procs, self.logs = procs, logs
        self.deadline = time.monotonic() + timeout_s
        self.timeout_s = timeout_s
        self._results = None

    @classmethod
    def start(cls, run_dir: Path, world: int, script: str, spec: dict,
              timeout_s: float = 240.0) -> "RankWorld":
        run_dir.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        procs, logs = [], []
        for r in range(world):
            s = dict(spec, rank=r, world=world, rdv=str(run_dir / "rdv"),
                     out=str(run_dir / f"out{r}.npz"), dir=str(run_dir))
            logs.append(run_dir / f"err{r}.txt")
            with open(logs[-1], "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", PREAMBLE + script,
                     json.dumps(s)],
                    cwd=str(ROOT), env=env, stdout=subprocess.DEVNULL,
                    stderr=err))
        return cls(run_dir, world, procs, logs, timeout_s)

    def wait(self):
        """Every rank's results (a dict of arrays), once."""
        if self._results is not None:
            return self._results
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
                p.wait()
            pytest.fail(f"ranks hung past {self.timeout_s} s:\n"
                        + "\n---\n".join(log.read_text()[-2000:]
                                         for log in self.logs))
        for p, log in zip(self.procs, self.logs):
            assert p.returncode == 0, log.read_text()[-4000:]
        self._results = [dict(np.load(self.run_dir / f"out{r}.npz"))
                         for r in range(self.world)]
        return self._results

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def save_arrays(path: Path, arrays: dict) -> str:
    np.savez(path, **arrays)
    return str(path)


def save_conf(path: Path, conf) -> str:
    path.write_text(json.dumps(conf.to_dict()))
    return str(path)
