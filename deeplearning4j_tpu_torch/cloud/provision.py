"""Fleet provisioning (reference:
``aws/ec2/Ec2BoxCreator.java:37`` — create N EC2 boxes from an AMI;
``aws/ec2/provision/ClusterSetup.java:38`` — provision master +
workers; ``aws/ec2/provision/HostProvisioner.java:1`` — SSH command
fan-out via JSch).

Counterpart of ``deeplearning4j_tpu/cloud/provision.py``: the same
plan, line for line, for the same inputs. The unit of provisioning is a
TPU pod slice: ``TpuPodProvisioner`` builds the ``gcloud compute tpus``
command plan (create / describe / ssh / delete) and each worker's
environment; ``ClusterSetup`` composes plan + per-worker setup
commands; ``HostProvisioner`` runs commands either locally
(dry-run/local worker) or through a user-supplied runner (ssh binary,
paramiko, CI executor). Everything is side-effect-free until a runner
is given — a provisioning plan you can read beats one that half-ran.

``worker_env``'s ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
``PROCESS_ID`` are the variables ``jax.distributed`` reads: a plan
emitted here launches the JAX package's workers. The port's
``parallel.mesh.init_distributed`` does not read these variables: it
takes an init method (``tcp://host:port`` or ``file://...``), a world size and a
rank as arguments, which a launch script of the port passes from these
same values (the address, the process count, the process id). A plan
for a fleet of H100 hosts is not emitted here."""

from __future__ import annotations

import shlex
import subprocess
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

# accelerator-type -> hosts for common v5e/v4 slices; used to derive
# NUM_PROCESSES for the jax.distributed bring-up
_SLICE_HOSTS = {
    "v5litepod-1": 1, "v5litepod-4": 1, "v5litepod-8": 1,
    "v5litepod-16": 4, "v5litepod-32": 8, "v5litepod-64": 16,
    "v5litepod-128": 32, "v5litepod-256": 64,
    "v4-8": 1, "v4-16": 2, "v4-32": 4, "v4-64": 8,
}


@dataclass
class TpuPodProvisioner:
    """Ec2BoxCreator analog: declares WHAT to create and emits the
    command plan that creates it (``Ec2BoxCreator.create()`` calls the
    EC2 API; here the plan is explicit and auditable)."""

    name: str
    accelerator_type: str = "v5litepod-8"
    zone: str = "us-central1-a"
    runtime_version: str = "v2-alpha-tpuv5-lite"
    project: Optional[str] = None
    preemptible: bool = False
    created: List[str] = field(default_factory=list)

    def _base(self) -> List[str]:
        cmd = ["gcloud", "compute", "tpus", "tpu-vm"]
        return cmd

    def _scope(self) -> List[str]:
        out = ["--zone", self.zone]
        if self.project:
            out += ["--project", self.project]
        return out

    def create_plan(self) -> List[str]:
        cmd = self._base() + ["create", self.name] + self._scope() + [
            "--accelerator-type", self.accelerator_type,
            "--version", self.runtime_version,
        ]
        if self.preemptible:
            cmd.append("--preemptible")
        return cmd

    def delete_plan(self) -> List[str]:
        return self._base() + ["delete", self.name, "--quiet"] + \
            self._scope()

    def ssh_plan(self, command: str, worker: str = "all") -> List[str]:
        return self._base() + ["ssh", self.name] + self._scope() + [
            "--worker", worker, "--command", command,
        ]

    def num_hosts(self) -> int:
        n = _SLICE_HOSTS.get(self.accelerator_type)
        if n is None:
            raise ValueError(
                f"unknown accelerator type "
                f"{self.accelerator_type!r}; known: "
                f"{sorted(_SLICE_HOSTS)}"
            )
        return n

    def worker_env(self, coordinator_host: str,
                   port: int = 8476) -> List[Dict[str, str]]:
        """Per-worker env as ``jax.distributed`` reads it (the reference
        wires master/worker addresses through ClusterSetup the same
        way); the port's ``init_distributed`` takes the same values as
        arguments."""
        n = self.num_hosts()
        return [
            {
                "COORDINATOR_ADDRESS": f"{coordinator_host}:{port}",
                "NUM_PROCESSES": str(n),
                "PROCESS_ID": str(i),
            }
            for i in range(n)
        ]

    def create(self, runner: Optional[Callable] = None) -> List[str]:
        """Execute the create plan (reference ``create():90`` runs the
        EC2 request). ``runner`` defaults to subprocess; the plan is
        returned either way and ``created`` records the pod."""
        plan = self.create_plan()
        if runner is not None:
            runner(plan)
        else:
            subprocess.run(plan, check=True)
        self.created.append(self.name)
        return plan


class HostProvisioner:
    """Per-host command execution (reference
    ``HostProvisioner.java:1`` — JSch SSH: uploadAndRun, runRemote).
    ``runner(cmd_list)`` abstracts the transport: default dry-run
    records, ``local_runner`` executes on this machine, and an
    ssh/gcloud runner executes remotely."""

    def __init__(self, host: str, runner: Optional[Callable] = None):
        self.host = host
        self.commands_run: List[List[str]] = []
        self._runner = runner

    @staticmethod
    def local_runner(cmd: List[str]):
        return subprocess.run(
            cmd, check=True, capture_output=True, text=True
        )

    def run(self, command) -> Optional[object]:
        cmd = (
            shlex.split(command) if isinstance(command, str)
            else list(command)
        )
        self.commands_run.append(cmd)
        if self._runner is None:
            return None  # dry-run: plan recorded, nothing executed
        return self._runner(cmd)

    def run_all(self, commands) -> None:
        for c in commands:
            self.run(c)


class ClusterSetup:
    """ClusterSetup analog (reference ``ClusterSetup.java:38``:
    create boxes -> provision master -> provision workers in threads).
    Here: build the pod plan, then the per-worker setup command list
    (install, fetch code, export the jax.distributed env, launch)."""

    def __init__(self, provisioner: TpuPodProvisioner,
                 setup_commands: Optional[List[str]] = None,
                 train_command: str = "python -m your_training_entry"):
        self.provisioner = provisioner
        self.setup_commands = setup_commands or []
        self.train_command = train_command

    def worker_launch_commands(
        self, coordinator_host: str, port: int = 8476
    ) -> List[str]:
        envs = self.provisioner.worker_env(coordinator_host, port)
        out = []
        for env in envs:
            exports = " ".join(
                # deliberately NOT shlex.quote'd: values are either
                # host:port/ints (shell-safe by construction) or a
                # ${VAR} placeholder the user substitutes when running
                # the emitted plan — quoting would freeze the literal
                f"{k}={v}" for k, v in sorted(env.items())
            )
            out.append(f"{exports} {self.train_command}")
        return out

    def plan(self, coordinator_host: str = "${COORDINATOR_HOST}",
             port: int = 8476) -> List[str]:
        """The full provisioning plan as shell lines — the auditable
        equivalent of ``ClusterSetup.exec()``."""
        lines = [shlex.join(self.provisioner.create_plan())]
        for cmd in self.setup_commands:
            lines.append(
                shlex.join(self.provisioner.ssh_plan(cmd))
            )
        for i, launch in enumerate(
            self.worker_launch_commands(coordinator_host, port)
        ):
            lines.append(
                shlex.join(
                    self.provisioner.ssh_plan(launch, worker=str(i))
                )
            )
        return lines

    def exec(self, coordinator_host: str, port: int = 8476,
             runner: Optional[Callable] = None) -> List[str]:
        """Run the plan (reference ``exec():76``). Dry-run (collect
        only) when ``runner`` is None — provisioning real fleets is a
        deliberate, credentialed action."""
        lines = self.plan(coordinator_host, port)
        if runner is not None:
            for line in lines:
                runner(shlex.split(line))
        return lines
