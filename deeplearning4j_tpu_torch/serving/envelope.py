"""Shared JSON error envelope + strict HTTP body reading.

Copy of ``deeplearning4j_tpu/serving/envelope.py``. Every error the
serving endpoints return is ONE shape:

    {"error": {"status": "<machine-readable slug>", "code": <http>,
               "message": "...", ...detail}}

so clients branch on ``error.status`` instead of parsing prose, and a
chaos run can assert "every response is a well-formed envelope"
uniformly. Server-side faults (model/transform exceptions) carry an
*opaque* ``error_id`` — never the exception text or a stack trace —
derived deterministically from the exception (sha-1 of type+message),
so (a) nothing internal leaks to clients, (b) operators can grep logs
for the id, and (c) a seeded chaos storm reproduces the same bodies
bit-for-bit.

``read_request_body`` fixes two classic stdlib-handler bugs: a single
``rfile.read(n)`` may legally return fewer than ``n`` bytes (short
read -> the tail of the JSON silently vanishes), and a missing
Content-Length used to be treated as an empty body. Here POSTs
without Content-Length get ``411``, short reads get ``400`` with
expected/got byte counts, and oversize bodies get ``413`` before any
bytes are buffered.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Optional

logger = logging.getLogger(__name__)


def error_envelope(status: str, code: int, message: Optional[str] = None,
                   **detail) -> dict:
    """Build the shared error envelope. ``detail`` keys (e.g.
    ``expected=``/``got=`` for 422, ``elapsed=``/``budget=`` for 504,
    ``retry_after=`` for 503) merge into the error object."""
    err = {"status": status, "code": int(code)}
    if message is not None:
        err["message"] = message
    err.update(detail)
    return {"error": err}


def deadline_envelope(deadline,
                      message: str = "request exceeded its deadline",
                      ) -> dict:
    """The one 504 shape every expiry site shares — queued-expired,
    handler-wait expiry, and drop-before-stacking in the micro-batch
    drain loop — so clients see identical ``elapsed``/``budget``
    detail regardless of where in the pipeline the budget ran out."""
    return error_envelope(
        "deadline_exceeded", 504, message,
        elapsed=round(deadline.elapsed(), 4),
        budget=deadline.budget,
    )


def error_id_for(exc: BaseException) -> str:
    """Opaque, deterministic id for a server-side exception:
    stable across runs for the same fault (chaos replays bit-for-bit)
    yet revealing nothing about it. The full exception belongs in the
    server log next to this id, never in the response."""
    digest = hashlib.sha1(
        f"{type(exc).__name__}:{exc}".encode("utf-8", "replace")
    ).hexdigest()
    return f"e{digest[:12]}"


class HttpBodyError(Exception):
    """A request body failed to arrive intact; carries the response
    the handler should write."""

    def __init__(self, code: int, envelope: dict):
        super().__init__(envelope["error"].get("message", ""))
        self.code = code
        self.envelope = envelope


def read_request_body(handler, max_body: int) -> bytes:
    """Read exactly Content-Length bytes from a
    ``BaseHTTPRequestHandler``, or raise ``HttpBodyError`` with the
    right status: 411 (no Content-Length), 400 (unparseable length or
    short read), 413 (over ``max_body``)."""
    raw = handler.headers.get("Content-Length")
    if raw is None:
        raise HttpBodyError(411, error_envelope(
            "length_required", 411,
            "POST requires a Content-Length header",
        ))
    try:
        length = int(raw)
        if length < 0:
            raise ValueError
    except ValueError:
        raise HttpBodyError(400, error_envelope(
            "bad_request", 400, f"bad Content-Length: {raw!r}",
        )) from None
    if length > max_body:
        raise HttpBodyError(413, error_envelope(
            "payload_too_large", 413,
            "request body exceeds the server cap",
            limit=max_body, got=length,
        ))
    chunks = []
    remaining = length
    while remaining:
        b = handler.rfile.read(min(remaining, 1 << 20))
        if not b:  # EOF before Content-Length bytes arrived
            raise HttpBodyError(400, error_envelope(
                "short_body", 400,
                "connection closed before the full body arrived",
                expected=length, got=length - remaining,
            ))
        chunks.append(b)
        remaining -= len(b)
    return b"".join(chunks)
