"""Cross-host elastic control plane: lease-based membership, epoch
fencing, and step-boundary barriers for multi-process training.

Counterpart of ``deeplearning4j_tpu/parallel/control_plane.py``. Every
robustness mechanism below this module (the snapshot ring, ZeRO
re-sharding) lives inside one process and dies with it. This module is
the cross-host rung: a small TCP **coordinator**
(:class:`LeaseCoordinator`) grants epoch-fenced membership **leases**
to per-process **worker agents** (:class:`WorkerAgent`), following the
coordinator/worker failure model of the TensorFlow system paper
(PAPERS.md, arxiv 1605.08695) and the reference's Spark master/worker
liveness:

- **Leases, not sessions.** A member holds the world only while it
  keeps renewing a time-bounded lease (renewals ride
  ``resilience/retry.py`` with bounded backoff). A missed lease
  declares the host dead; there is no graceful-disconnect
  requirement, so SIGKILL and network partition look identical.
- **Epoch fencing.** Every membership change bumps the **epoch**.
  Requests stamped with a stale epoch are rejected with the current
  recovery plan, and a declared-dead member is *fenced*: its old
  identity can never act again (zombie writes from a paused or
  partitioned host cannot corrupt the new world). A fenced host may
  rejoin, as a *fresh* member admitted at the next epoch bump.
- **Step barriers.** Workers arrive at a barrier at every step
  boundary; the coordinator releases it when every current member has
  arrived. Arrival renews the lease, so a worker blocked on slow
  peers never expires. A death observed while others wait converts
  the barrier into a recovery plan for the survivors, all of whom
  therefore agree on the recovery point.
- **Recovery plans.** The coordinator answers a stale epoch with a
  :class:`RecoveryPlan`: the new epoch and term, the survivor set in
  rank order, and a fresh ``torch.distributed`` rendezvous
  (``tcp://host:port``, a new port each term: a half-dead process
  group's store is never reused; the JAX package's field is
  ``jax_coordinator``, a ``jax.distributed`` coordinator). The
  training side of recovery (snapshot rollback, re-forming the process
  group, ZeRO re-shard) lives in ``parallel/elastic.HostElasticTrainer``.
- **Graceful degradation.** Coordinator loss is detected by retry
  exhaustion (:class:`CoordinatorLostException`); the fit driver
  checkpoints and exits with the preemption exit codes (75/76)
  rather than hang or train a partitioned brain.

The protocol is line-delimited JSON over TCP (one request a
connection, no long-lived sockets to leak into forked children), and
the state machine (:class:`LeaseState`) is pure and clock-injectable,
so the fencing, expiry and rejoin logic is unit-testable under a fake
clock with no sockets or threads (``LocalTransport``).
"""

from __future__ import annotations

import json
import logging
import os
import random
import socket
import socketserver
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.exceptions import (
    DL4JFaultException, DeadlineExceededException,
    RetryExhaustedException,
)
from deeplearning4j_tpu_torch.observability import flightrec
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, retry_call

logger = logging.getLogger(__name__)


def _default_registry():
    from deeplearning4j_tpu_torch.observability.metrics import default_registry

    return default_registry()


class ControlPlaneException(DL4JFaultException):
    """Base for control-plane faults."""


class CoordinatorLostException(ControlPlaneException):
    """The control coordinator became unreachable (retries exhausted).
    Membership truth is gone: the fit driver checkpoints and exits
    with the preemption exit codes instead of hanging."""


class HostFencedException(ControlPlaneException):
    """This member was declared dead and fenced out of the epoch. Its
    training state is a zombie's — it must NOT be checkpointed or
    pushed anywhere; the process may only rejoin as a fresh member."""


@dataclass(frozen=True)
class RecoveryPlan:
    """What the coordinator hands a survivor at an epoch bump: the new
    membership in rank order plus a fresh ``torch.distributed``
    rendezvous (``tcp://host:port``) for the re-formed process group."""

    epoch: int
    term: int
    members: Tuple[int, ...]
    num: int
    rendezvous: str
    member: Optional[int] = None   # the recipient's member id
    rank: Optional[int] = None     # ... and its rank in the new mesh
    dead: Tuple[int, ...] = ()
    admitted: Tuple[int, ...] = ()
    lease_s: float = 2.0

    @classmethod
    def from_dict(cls, d: dict) -> "RecoveryPlan":
        return cls(
            epoch=int(d["epoch"]), term=int(d["term"]),
            members=tuple(int(m) for m in d["members"]),
            num=int(d["num"]), rendezvous=str(d["rendezvous"]),
            member=(None if d.get("member") is None
                    else int(d["member"])),
            rank=None if d.get("rank") is None else int(d["rank"]),
            dead=tuple(int(m) for m in d.get("dead", ())),
            admitted=tuple(int(m) for m in d.get("admitted", ())),
            lease_s=float(d.get("lease_s", 2.0)),
        )


def _ephemeral_port(host: str = "127.0.0.1") -> int:
    """Bind-and-release port pick for the NEXT rendezvous. The
    release-to-bind window is racy by nature; consumers retry the
    bring-up (``mesh.init_distributed_elastic``) rather than trust the
    reservation."""
    s = socket.socket()
    try:
        s.bind((host, 0))
        return s.getsockname()[1]
    finally:
        s.close()


class LeaseState:
    """The coordinator's pure state machine: membership, leases,
    epochs, fences, barriers. Clock-injectable and lock-protected;
    contains no sockets or threads of its own, so every transition is
    unit-testable under a fake clock.

    Lifecycle: ``expected`` members join during epoch 0 (formation;
    leases are not swept until the mesh has formed once). When the
    last one arrives the state *reforms* — epoch/term bump to 1, a
    plan is published, everyone gets a fresh lease. From then on any
    expiry, graceful leave, or admitted rejoin reforms again: new
    epoch, new term, fresh ``rendezvous`` port, fences for the
    dead."""

    def __init__(self, num_processes: int, *, lease_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 host: str = "127.0.0.1",
                 port_factory: Optional[Callable[[], int]] = None,
                 admit_joins: bool = True, registry=None):
        if num_processes < 1:
            raise ValueError("num_processes must be >= 1")
        if lease_s <= 0:
            raise ValueError("lease_s must be > 0")
        self.expected = int(num_processes)
        self.lease_s = float(lease_s)
        self.clock = clock
        self.host = host
        self.admit_joins = bool(admit_joins)
        self._port_factory = port_factory or (
            lambda: _ephemeral_port(host))
        self.epoch = 0
        self.term = 0
        self.members: Dict[int, float] = {}   # member id -> lease expiry
        self.pending: List[int] = []          # joins awaiting admission
        self.fenced: set = set()              # dead member ids (sticky)
        self.plan: Optional[dict] = None      # current epoch's plan
        self._arrived: Dict[int, set] = {}    # barrier step -> member ids
        self._synced: Dict[str, Dict[int, object]] = {}  # key -> payloads
        self._next_id = 0
        self.cond = threading.Condition()
        registry = registry if registry is not None else _default_registry()
        self._m_renewals = registry.counter(
            "lease_renewals_total",
            help="successful membership lease renewals",
        )._default()
        self._m_expired = registry.counter(
            "lease_expired_total",
            help="membership leases expired (host declared dead)",
            labels=("shard",),
        )
        self._m_epoch = registry.gauge(
            "control_epoch",
            help="current control-plane membership epoch",
        )._default()

    # -- internals (caller holds self.cond) -----------------------------

    def _sweep_locked(self) -> None:
        if self.epoch == 0:
            return  # formation grace: nobody expires before first form
        now = self.clock()
        expired = sorted(m for m, exp in self.members.items()
                         if exp <= now)
        if not expired:
            return
        for m in expired:
            del self.members[m]
            self.fenced.add(m)
            self._m_expired.labels(str(m)).inc()
            logger.warning(
                "control plane: member %d lease expired at epoch %d "
                "— declared dead and fenced", m, self.epoch)
            flightrec.record_event("lease_expired", member=m,
                                   epoch=self.epoch)
        self._reform_locked(dead=expired)

    def _reform_locked(self, dead: Sequence[int] = ()) -> None:
        admitted = []
        while self.pending:
            m = self.pending.pop(0)
            admitted.append(m)
            self.members[m] = 0.0  # expiry set below
        self.epoch += 1
        self.term += 1
        self._m_epoch.set(float(self.epoch))
        if not self.members:
            self.plan = None
            self.cond.notify_all()
            return
        fresh = self.clock() + self.lease_s
        for m in self.members:
            self.members[m] = fresh
        order = sorted(self.members)
        self.plan = {
            "epoch": self.epoch, "term": self.term, "members": order,
            "num": len(order),
            "rendezvous": "tcp://%s:%d" % (self.host,
                                           int(self._port_factory())),
            "dead": sorted(int(m) for m in dead),
            "admitted": admitted, "lease_s": self.lease_s,
        }
        self._arrived = {}
        self._synced = {}
        flightrec.record_event(
            "control_epoch", epoch=self.epoch, term=self.term,
            num=len(order), dead=self.plan["dead"], admitted=admitted)
        self.cond.notify_all()

    def _plan_for_locked(self, member: int) -> dict:
        plan = dict(self.plan)
        plan["member"] = member
        plan["rank"] = self.plan["members"].index(member)
        return plan

    # -- membership ------------------------------------------------------

    def join(self, member_hint: Optional[int] = None) -> int:
        """Register a joiner; returns its member id. During formation
        (epoch 0) a free ``member_hint`` is honored so ranks can keep
        their launcher-assigned ids; after formation every joiner —
        including a fenced host coming back — is a FRESH member queued
        for admission at the next epoch bump."""
        with self.cond:
            self._sweep_locked()
            if self.epoch == 0 and len(self.members) < self.expected:
                if (member_hint is not None
                        and int(member_hint) not in self.members):
                    mid = int(member_hint)
                else:
                    mid = self._next_id
                self._next_id = max(self._next_id, mid + 1)
                self.members[mid] = self.clock() + self.lease_s
                if len(self.members) == self.expected:
                    self._reform_locked()
                else:
                    self.cond.notify_all()
                return mid
            mid = self._next_id
            self._next_id += 1
            self.pending.append(mid)
            flightrec.record_event("member_join_pending", member=mid,
                                   epoch=self.epoch)
            self.cond.notify_all()
            return mid

    def grant_for(self, member: int) -> Optional[dict]:
        """The member's current grant: ``None`` while the mesh is
        still forming or the member awaits admission; a fence error
        once declared dead; otherwise the personalized plan."""
        with self.cond:
            self._sweep_locked()
            if member in self.fenced:
                return {"ok": False, "error": "fenced",
                        "epoch": self.epoch}
            if self.plan is None or member not in self.members:
                return None
            out = self._plan_for_locked(member)
            out["ok"] = True
            return out

    def touch(self, member: int) -> None:
        """Refresh a live member's lease without an epoch check (used
        while it blocks on formation). Never resurrects."""
        with self.cond:
            if member in self.members:
                self.members[member] = self.clock() + self.lease_s

    def renew(self, member: int, epoch: int) -> dict:
        with self.cond:
            self._sweep_locked()
            if member in self.fenced or member not in self.members:
                return {"ok": False, "error": "fenced",
                        "epoch": self.epoch}
            if int(epoch) != self.epoch:
                # the member is alive, just behind: its renewal still
                # proves liveness, so extend the lease — a survivor
                # mid-recovery (a slow process-group re-formation) must
                # not expire because its renewals carry yesterday's epoch
                self.members[member] = self.clock() + self.lease_s
                return {"ok": False, "error": "stale_epoch",
                        "epoch": self.epoch,
                        "plan": self._plan_for_locked(member)}
            self.members[member] = self.clock() + self.lease_s
            self._m_renewals.inc()
            return {"ok": True, "epoch": self.epoch,
                    "lease_s": self.lease_s}

    def leave(self, member: int) -> dict:
        """Graceful departure: fence the identity and reform over the
        remainder (a planned downscale, minus the expiry wait)."""
        with self.cond:
            self._sweep_locked()
            if member in self.members:
                del self.members[member]
                self.fenced.add(member)
                self._reform_locked(dead=[member])
            return {"ok": True, "epoch": self.epoch}

    # -- barrier ---------------------------------------------------------

    def arrive(self, member: int, epoch: int, step: int) -> dict:
        """Non-blocking barrier arrival: returns a decision —
        ``proceed`` (everyone arrived), ``wait`` (peers outstanding),
        or an error (``fenced`` / ``stale_epoch`` + plan). Arrival
        renews the lease, so a member blocked on stragglers never
        expires; a pending join converts the boundary into an epoch
        bump so rejoiners are admitted between steps, never mid-step."""
        with self.cond:
            self._sweep_locked()
            if member in self.fenced or member not in self.members:
                return {"ok": False, "error": "fenced",
                        "epoch": self.epoch}
            if int(epoch) != self.epoch:
                return {"ok": False, "error": "stale_epoch",
                        "epoch": self.epoch,
                        "plan": self._plan_for_locked(member)}
            if self.pending and self.admit_joins:
                self._reform_locked()
                return {"ok": False, "error": "stale_epoch",
                        "epoch": self.epoch,
                        "plan": self._plan_for_locked(member)}
            self.members[member] = self.clock() + self.lease_s
            step = int(step)
            got = self._arrived.setdefault(step, set())
            got.add(member)
            if set(self.members) <= got:
                for s in [s for s in self._arrived if s < step]:
                    del self._arrived[s]
                self.cond.notify_all()
                return {"ok": True, "decision": "proceed",
                        "epoch": self.epoch, "step": step}
            return {"ok": True, "decision": "wait",
                    "epoch": self.epoch, "step": step}

    def barrier_wait(self, member: int, epoch: int, step: int,
                     timeout_s: float, poll_s: float = 0.05) -> dict:
        """Blocking barrier (real-clock server handlers only): poll
        :meth:`arrive` until it decides. Each poll renews the lease."""
        deadline = self.clock() + timeout_s
        poll_s = min(poll_s, self.lease_s / 4.0)
        while True:
            r = self.arrive(member, epoch, step)
            if r.get("decision") != "wait":
                return r
            with self.cond:
                if self.clock() >= deadline:
                    return {"ok": False, "error": "barrier_timeout",
                            "epoch": self.epoch, "step": step}
                self.cond.wait(poll_s)

    def sync(self, member: int, epoch: int, key: str,
             payload=None) -> dict:
        """Payload-carrying named barrier — the two-phase checkpoint
        commit fence. Like :meth:`arrive`, but each member brings a
        JSON payload (its shard digest) and ``proceed`` returns
        everyone's, so all ranks leave the barrier knowing every
        shard is durable before rank 0 writes the manifest. Keys are
        opaque strings in a namespace separate from step barriers,
        and — unlike ``arrive`` — a pending join does NOT bump the
        epoch here: sync barriers run off the step path (background
        checkpoint commits) and must not steal the admission point
        from the step barrier. Any epoch bump (death, admission)
        clears in-flight sync keys, so a commit can never span a
        membership change."""
        with self.cond:
            self._sweep_locked()
            if member in self.fenced or member not in self.members:
                return {"ok": False, "error": "fenced",
                        "epoch": self.epoch}
            if int(epoch) != self.epoch:
                return {"ok": False, "error": "stale_epoch",
                        "epoch": self.epoch,
                        "plan": self._plan_for_locked(member)}
            self.members[member] = self.clock() + self.lease_s
            key = str(key)
            got = self._synced.setdefault(key, {})
            got[member] = payload
            if set(self.members) <= set(got):
                # bounded: drop oldest completed keys (keep a few so
                # stragglers re-polling a just-released key still see
                # proceed; a straggler past that re-arrives, idempotent)
                while len(self._synced) > 8:
                    oldest = next(iter(self._synced))
                    if oldest == key:
                        break
                    del self._synced[oldest]
                self.cond.notify_all()
                return {"ok": True, "decision": "proceed",
                        "epoch": self.epoch, "key": key,
                        "payloads": {str(m): got[m]
                                     for m in sorted(got)}}
            return {"ok": True, "decision": "wait",
                    "epoch": self.epoch, "key": key}

    def sync_wait(self, member: int, epoch: int, key: str, payload,
                  timeout_s: float, poll_s: float = 0.05) -> dict:
        """Blocking :meth:`sync` (real-clock server handlers only)."""
        deadline = self.clock() + timeout_s
        poll_s = min(poll_s, self.lease_s / 4.0)
        while True:
            r = self.sync(member, epoch, key, payload)
            if r.get("decision") != "wait":
                return r
            with self.cond:
                if self.clock() >= deadline:
                    return {"ok": False, "error": "barrier_timeout",
                            "epoch": self.epoch, "key": key}
                self.cond.wait(poll_s)

    def join_wait(self, member_hint: Optional[int], timeout_s: float,
                  poll_s: float = 0.05) -> dict:
        """Blocking join (server handlers): register, then wait for
        formation/admission. Keeps the pre-formation lease fresh."""
        mid = self.join(member_hint)
        deadline = self.clock() + timeout_s
        while True:
            g = self.grant_for(mid)
            if g is not None:
                return g
            with self.cond:
                if self.clock() >= deadline:
                    return {"ok": False, "error": "join_timeout",
                            "member": mid, "epoch": self.epoch}
                self.touch(mid)
                self.cond.wait(poll_s)

    def info(self) -> dict:
        with self.cond:
            self._sweep_locked()
            return {"ok": True, "epoch": self.epoch, "term": self.term,
                    "members": sorted(self.members),
                    "pending": list(self.pending),
                    "fenced": sorted(self.fenced),
                    "expected": self.expected}


class LeaseCoordinator:
    """TCP front for :class:`LeaseState`: a threading server speaking
    one line-delimited JSON request per connection. Ops: ``join``
    (blocking until formation/admission), ``grant``, ``renew``,
    ``barrier`` (blocking), ``leave``, ``info``."""

    def __init__(self, num_processes: int, *, host: str = "127.0.0.1",
                 port: int = 0, lease_s: float = 2.0,
                 join_timeout_s: float = 60.0,
                 barrier_timeout_s: float = 120.0,
                 port_factory: Optional[Callable[[], int]] = None,
                 admit_joins: bool = True, registry=None):
        self.state = LeaseState(
            num_processes, lease_s=lease_s, host=host,
            port_factory=port_factory, admit_joins=admit_joins,
            registry=registry,
        )
        self.join_timeout_s = float(join_timeout_s)
        self.barrier_timeout_s = float(barrier_timeout_s)
        coordinator = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    line = self.rfile.readline()
                    if not line:
                        return
                    resp = coordinator._dispatch(
                        json.loads(line.decode("utf-8")))
                except Exception as e:  # never kill the server thread
                    logger.warning("control plane: bad request: %r", e)
                    resp = {"ok": False, "error": "coordinator_error",
                            "detail": str(e)[:200]}
                try:
                    self.wfile.write(
                        (json.dumps(resp) + "\n").encode("utf-8"))
                except Exception:
                    pass  # client went away mid-reply

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return "%s:%d" % (self.host, self.port)

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        st = self.state
        if op == "join":
            return st.join_wait(req.get("member"),
                                float(req.get("timeout_s",
                                              self.join_timeout_s)))
        if op == "grant":
            g = st.grant_for(int(req["member"]))
            if g is None:
                return {"ok": True, "decision": "wait",
                        "member": int(req["member"]),
                        "epoch": st.epoch}
            return g
        if op == "renew":
            return st.renew(int(req["member"]), int(req["epoch"]))
        if op == "barrier":
            return st.barrier_wait(
                int(req["member"]), int(req["epoch"]),
                int(req["step"]),
                float(req.get("timeout_s", self.barrier_timeout_s)))
        if op == "sync":
            return st.sync_wait(
                int(req["member"]), int(req["epoch"]),
                str(req["key"]), req.get("payload"),
                float(req.get("timeout_s", self.barrier_timeout_s)))
        if op == "leave":
            return st.leave(int(req["member"]))
        if op == "info":
            return st.info()
        return {"ok": False, "error": "bad_op", "op": str(op)[:40]}

    def start(self) -> "LeaseCoordinator":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="lease-coordinator",
            daemon=True)
        self._thread.start()
        logger.info("control plane: coordinator on %s (expecting %d)",
                    self.address, self.state.expected)
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "LeaseCoordinator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class TcpTransport:
    """One JSON request per fresh connection. Stateless between
    requests so chaos (drop/partition) and retries compose cleanly."""

    def __init__(self, address: str, *, timeout_s: float = 5.0):
        host, _, port = address.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.timeout_s = float(timeout_s)

    def request(self, payload: dict,
                timeout_s: Optional[float] = None) -> dict:
        t = self.timeout_s if timeout_s is None else float(timeout_s)
        with socket.create_connection((self.host, self.port),
                                      timeout=t) as s:
            s.settimeout(t)
            s.sendall((json.dumps(payload) + "\n").encode("utf-8"))
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
        if not buf:
            raise ConnectionError("control coordinator closed the "
                                  "connection without a reply")
        return json.loads(buf.decode("utf-8"))


class LocalTransport:
    """In-process transport driving a :class:`LeaseState` directly —
    no sockets, no threads, fake-clock friendly. Blocking ops return
    ``wait`` decisions instead of blocking; :class:`WorkerAgent`
    polls, so agent behavior is identical over both transports."""

    def __init__(self, state: LeaseState):
        self.state = state

    def request(self, payload: dict,
                timeout_s: Optional[float] = None) -> dict:
        op = payload.get("op")
        st = self.state
        if op == "join":
            mid = st.join(payload.get("member"))
            g = st.grant_for(mid)
            if g is None:
                return {"ok": True, "decision": "wait", "member": mid,
                        "epoch": st.epoch}
            g.setdefault("member", mid)
            return g
        if op == "grant":
            g = st.grant_for(int(payload["member"]))
            if g is None:
                return {"ok": True, "decision": "wait",
                        "member": int(payload["member"]),
                        "epoch": st.epoch}
            return g
        if op == "renew":
            return st.renew(int(payload["member"]),
                            int(payload["epoch"]))
        if op == "barrier":
            return st.arrive(int(payload["member"]),
                             int(payload["epoch"]),
                             int(payload["step"]))
        if op == "sync":
            return st.sync(int(payload["member"]),
                           int(payload["epoch"]),
                           str(payload["key"]),
                           payload.get("payload"))
        if op == "leave":
            return st.leave(int(payload["member"]))
        if op == "info":
            return st.info()
        return {"ok": False, "error": "bad_op"}


class WorkerAgent:
    """One per training process: joins the coordinator, renews its
    lease from a background thread (rank-seeded jitter so a fleet's
    renewals decorrelate), arrives at step barriers, and converts
    protocol outcomes into the exceptions/plans the fit driver acts
    on — ``stale_epoch`` becomes a :class:`RecoveryPlan`, ``fenced``
    a :class:`HostFencedException`, and retry exhaustion against the
    transport a :class:`CoordinatorLostException`."""

    def __init__(self, transport, *, rank_hint: Optional[int] = None,
                 policy: Optional[RetryPolicy] = None,
                 renew_jitter: float = 0.2, poll_s: float = 0.05,
                 barrier_timeout_s: float = 120.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 registry=None):
        if isinstance(transport, str):
            transport = TcpTransport(transport)
        self.transport = transport
        self.rank_hint = rank_hint
        self.policy = policy or RetryPolicy(
            max_attempts=4, base_delay=0.25, max_delay=2.0,
            total_timeout=15.0,
            seed=rank_hint if rank_hint is not None else 0,
        )
        self.poll_s = float(poll_s)
        self.barrier_timeout_s = float(barrier_timeout_s)
        self.clock = clock
        self.sleep = sleep
        self.member: Optional[int] = None
        self.epoch = 0
        self.rank: Optional[int] = None
        self.num: Optional[int] = None
        self.rendezvous: Optional[str] = None
        self.lease_s: Optional[float] = None
        self._jitter = float(renew_jitter)
        self._rng = random.Random(
            rank_hint if rank_hint is not None else 0)
        self._lock = threading.Lock()
        self._plan: Optional[RecoveryPlan] = None
        self._fenced = False
        self._lost = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        registry = registry if registry is not None else _default_registry()
        self._m_rtt = registry.summary(
            "control_rtt_ms",
            help="control-plane request round-trip latency (ms)",
        )._default()

    # -- wire ------------------------------------------------------------

    def _call(self, payload: dict,
              timeout_s: Optional[float] = None) -> dict:
        t0 = self.clock()
        try:
            resp = retry_call(self.transport.request, payload,
                              timeout_s=timeout_s, policy=self.policy)
        except (RetryExhaustedException,
                DeadlineExceededException) as e:
            with self._lock:
                self._lost = True
            raise CoordinatorLostException(
                "control coordinator unreachable "
                f"(op={payload.get('op')!r}, member={self.member})"
            ) from e
        self._m_rtt.observe((self.clock() - t0) * 1000.0)
        if resp.get("error") == "fenced":
            with self._lock:
                self._fenced = True
            raise HostFencedException(
                f"member {self.member} fenced at epoch "
                f"{resp.get('epoch')}: a zombie must not touch the "
                "mesh (rejoin as a fresh member)"
            )
        return resp

    def _stash_plan(self, resp: dict) -> Optional[RecoveryPlan]:
        """Stash a stale-epoch plan for the fit loop — but only when
        it is NEWER than the epoch this agent already adopted. A
        late-arriving response from a pre-recovery request (the
        renewal thread racing the barrier) must not re-trigger the
        same recovery."""
        plan = RecoveryPlan.from_dict(resp["plan"])
        with self._lock:
            if plan.epoch <= self.epoch:
                return None
            self._plan = plan
        return plan

    # -- membership ------------------------------------------------------

    def join(self, timeout_s: float = 60.0) -> RecoveryPlan:
        """Join and block until the mesh forms (or this member is
        admitted at an epoch bump). Returns the initial grant."""
        deadline = self.clock() + timeout_s
        resp = self._call({"op": "join", "member": self.rank_hint,
                           "timeout_s": timeout_s},
                          timeout_s=timeout_s + 10.0)
        while resp.get("decision") == "wait":
            self.member = int(resp.get("member", -1))
            if self.clock() >= deadline:
                raise CoordinatorLostException(
                    f"mesh never formed within {timeout_s}s "
                    f"(member={self.member})")
            self.sleep(self.poll_s)
            resp = self._call({"op": "grant", "member": self.member})
        if resp.get("error") == "join_timeout":
            raise CoordinatorLostException(
                f"mesh never formed within {timeout_s}s "
                f"(member={resp.get('member')})")
        plan = RecoveryPlan.from_dict(resp)
        self.adopt(plan)
        logger.info(
            "control plane: joined as member %d rank %d/%d epoch %d",
            plan.member, plan.rank, plan.num, plan.epoch)
        return plan

    def adopt(self, plan: RecoveryPlan) -> None:
        """Make ``plan`` this agent's current epoch. Called BEFORE the
        process group re-forms, so background renewals carry the new
        epoch and keep the lease alive through a slow re-init."""
        member = plan.member if plan.member is not None else self.member
        with self._lock:
            self.member = member
            self.epoch = plan.epoch
            self.rank = (plan.rank if plan.rank is not None
                         else plan.members.index(member))
            self.num = plan.num
            self.rendezvous = plan.rendezvous
            self.lease_s = plan.lease_s
            self._plan = None

    def renew(self) -> Optional[RecoveryPlan]:
        """One lease renewal. Returns a plan when the epoch moved."""
        resp = self._call({"op": "renew", "member": self.member,
                           "epoch": self.epoch})
        if resp.get("error") == "stale_epoch":
            return self._stash_plan(resp)
        return None

    def leave(self) -> None:
        self._call({"op": "leave", "member": self.member})

    # -- the renewal thread ---------------------------------------------

    def next_interval(self) -> float:
        """Renewal interval: a third of the lease, jittered by a
        rank-seeded rng (the ``ServingRouter.health_jitter`` pattern)
        so a fleet's renewals don't synchronize into bursts."""
        base = (self.lease_s or 2.0) / 3.0
        return base * (1.0 + self._jitter * (2.0 * self._rng.random()
                                             - 1.0))

    def start_renewals(self) -> None:
        if self._thread is not None:
            return

        def _loop():
            while not self._stop.wait(self.next_interval()):
                try:
                    # a newer plan gets stashed for the next barrier;
                    # keep renewing regardless — stale-epoch renewals
                    # still extend the lease, keeping this host alive
                    # through a slow recovery
                    self.renew()
                except (CoordinatorLostException,
                        HostFencedException):
                    return  # verdict stashed; surfaced at the barrier
                except Exception as e:
                    logger.warning(
                        "control plane: renewal hiccup: %r", e)

        self._thread = threading.Thread(
            target=_loop, name="lease-renewals", daemon=True)
        self._thread.start()

    def stop_renewals(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._thread = None
        self._stop = threading.Event()

    # -- step boundary ---------------------------------------------------

    def pending_plan(self) -> Optional[RecoveryPlan]:
        with self._lock:
            return self._plan

    def raise_verdicts(self) -> None:
        """Surface a terminal verdict reached by the renewal thread."""
        with self._lock:
            fenced, lost = self._fenced, self._lost
        if fenced:
            raise HostFencedException(
                f"member {self.member} fenced at epoch {self.epoch}")
        if lost:
            raise CoordinatorLostException(
                "control coordinator unreachable (renewal thread "
                "exhausted its retries)")

    def step_barrier(self, step: int,
                     timeout_s: Optional[float] = None
                     ) -> Optional[RecoveryPlan]:
        """Arrive at the step barrier; block until every member has.
        Returns ``None`` to proceed, or a :class:`RecoveryPlan` when
        the epoch moved (host died / member admitted) — the caller
        runs recovery, then :meth:`adopt` makes the plan current."""
        self.raise_verdicts()
        plan = self.pending_plan()
        if plan is not None:
            return plan
        timeout_s = (self.barrier_timeout_s if timeout_s is None
                     else float(timeout_s))
        deadline = self.clock() + timeout_s
        while True:
            resp = self._call(
                {"op": "barrier", "member": self.member,
                 "epoch": self.epoch, "step": int(step),
                 "timeout_s": timeout_s},
                timeout_s=timeout_s + 10.0)
            if resp.get("decision") == "wait":
                if self.clock() >= deadline:
                    raise ControlPlaneException(
                        f"step barrier {step} timed out after "
                        f"{timeout_s}s (epoch {self.epoch}): peers "
                        "wedged but not declared dead")
                self.sleep(self.poll_s)
                continue
            if resp.get("error") == "stale_epoch":
                plan = self._stash_plan(resp)
                if plan is not None:
                    return plan
                continue  # epoch already adopted: re-arrive under it
            if resp.get("error") == "barrier_timeout":
                raise ControlPlaneException(
                    f"step barrier {step} timed out after {timeout_s}s "
                    f"(epoch {self.epoch}): peers wedged but not "
                    "declared dead")
            return None

    def sync_barrier(self, key: str, payload=None,
                     timeout_s: Optional[float] = None
                     ) -> Optional[Dict[int, object]]:
        """Payload-carrying named barrier — the checkpoint commit
        fence. Blocks until every member of the current epoch arrives
        with its payload, then returns ``{member_id: payload}`` for
        all of them. Returns ``None`` when the epoch moved underneath
        (a member died or was admitted): the caller's commit MUST
        abort — the membership its shards were written under no
        longer exists. Safe from any thread (each request rides a
        fresh connection), which is the point: write-behind
        checkpoint writers commit here without touching the training
        thread's step barriers."""
        self.raise_verdicts()
        timeout_s = (self.barrier_timeout_s if timeout_s is None
                     else float(timeout_s))
        deadline = self.clock() + timeout_s
        while True:
            resp = self._call(
                {"op": "sync", "member": self.member,
                 "epoch": self.epoch, "key": str(key),
                 "payload": payload, "timeout_s": timeout_s},
                timeout_s=timeout_s + 10.0)
            if resp.get("decision") == "wait":
                if self.clock() >= deadline:
                    raise ControlPlaneException(
                        f"sync barrier {key!r} timed out after "
                        f"{timeout_s}s (epoch {self.epoch}): peers "
                        "wedged but not declared dead")
                self.sleep(self.poll_s)
                continue
            if resp.get("error") == "stale_epoch":
                self._stash_plan(resp)
                return None
            if resp.get("error") == "barrier_timeout":
                raise ControlPlaneException(
                    f"sync barrier {key!r} timed out after "
                    f"{timeout_s}s (epoch {self.epoch}): peers wedged "
                    "but not declared dead")
            return {int(m): p
                    for m, p in resp.get("payloads", {}).items()}

    def close(self, leave: bool = False) -> None:
        """Stop renewing; optionally a graceful ``leave`` (off by
        default — at normal end-of-fit every member finishes the same
        final barrier, so departing silently avoids a pointless
        tail of epoch bumps)."""
        self.stop_renewals()
        if leave and self.member is not None:
            try:
                self.leave()
            except ControlPlaneException:
                pass


# -- fit-driver hook (the preemption._active pattern) --------------------

_active_agent: Optional[WorkerAgent] = None


def install_agent(agent: WorkerAgent) -> WorkerAgent:
    """Make ``agent`` the process-wide control-plane agent the fit
    drivers consult (``check_fit``). One per process, like the
    preemption handler."""
    global _active_agent
    _active_agent = agent
    return agent


def uninstall_agent(agent: Optional[WorkerAgent] = None) -> None:
    global _active_agent
    if agent is None or _active_agent is agent:
        _active_agent = None


def active_agent() -> Optional[WorkerAgent]:
    return _active_agent


def check_fit(model=None) -> None:
    """Fast-path hook for the single-process fit drivers: surface a
    fence/coordinator-loss verdict reached by the renewal thread
    between barriers. No-op (one attribute read + branch) when no
    agent is installed."""
    agent = _active_agent
    if agent is None:
        return
    agent.raise_verdicts()
