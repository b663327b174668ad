"""Exceptions of the port: the hierarchy of the JAX package's
``exceptions.py``, so ``except DL4JFaultException`` (and ``except
ValueError`` for the config and input errors) catches the same faults
in both packages."""


class DL4JException(Exception):
    """Base of the framework's exceptions."""


class DL4JInvalidConfigException(DL4JException, ValueError):
    """A configuration that cannot be built or run."""


class DL4JInvalidInputException(DL4JException, ValueError):
    """Input incompatible with the network."""


class DL4JFaultException(DL4JException):
    """A runtime fault (a process group that cannot be formed or is
    formed twice, a lost peer, a preempted worker, flaky storage, a
    corrupted checkpoint, diverged training)."""


class CheckpointCorruptedException(DL4JFaultException):
    """A checkpoint failed verification (CRC mismatch, truncated zip,
    missing members) and no earlier version could be restored."""


class CheckpointCommitAbortedException(DL4JFaultException):
    """A sharded checkpoint's two-phase commit aborted: the membership
    the shards were written under changed, or the commit barrier failed
    before rank 0 could write the manifest. The uncommitted directory
    is ignored by restore and collected by GC."""


class RetryExhaustedException(DL4JFaultException):
    """A retried operation failed on every attempt of its budget;
    carries the attempt count and the last cause (also chained as
    ``__cause__``)."""

    def __init__(self, message: str, attempts: int,
                 last_cause: BaseException):
        super().__init__(message)
        self.attempts = attempts
        self.last_cause = last_cause


class CircuitOpenException(DL4JFaultException):
    """A call rejected because its ``CircuitBreaker`` is open;
    ``retry_after`` is the seconds until the breaker admits a probe."""

    def __init__(self, message: str, retry_after: float = 0.0):
        super().__init__(message)
        self.retry_after = retry_after


class DeadlineExceededException(DL4JFaultException):
    """A request outlived its deadline; carries ``elapsed`` and
    ``budget`` in seconds. Not a ``TimeoutError``, so the default retry
    allowlist never retries an expired budget."""

    def __init__(self, message: str, elapsed: float, budget: float):
        super().__init__(message)
        self.elapsed = elapsed
        self.budget = budget
