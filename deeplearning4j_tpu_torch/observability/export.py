"""Registry exporters: Prometheus text exposition and a JSON snapshot.

Counterpart of ``deeplearning4j_tpu/observability/export.py``, kept as
the port's own copy. The exposition format (text/plain; version=0.0.4)
lets any standard collector scrape the serving endpoint
(``GET /metrics?format=prometheus``); JSON stays the default. The rules:

- a ``# HELP`` / ``# TYPE`` header per family (HELP only where a help
  string was registered; HELP text escapes ``\\`` and newline);
- label values escape backslash, double quote and newline;
- histograms emit cumulative ``_bucket{le="..."}`` series ending at
  ``le="+Inf"`` == ``_count``, plus ``_sum``;
- summaries emit ``{quantile="..."}`` series plus ``_sum`` / ``_count``
  (nearest-rank quantiles of the reservoir's recent window, absent
  while it is empty).
"""

from __future__ import annotations

import math
from typing import Optional

from deeplearning4j_tpu_torch.observability.metrics import (
    COUNTER,
    GAUGE,
    HISTOGRAM,
    SUMMARY,
    MetricsRegistry,
)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_str(names, values, extra=()) -> str:
    pairs = [
        f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)
    ]
    pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render every family in ``registry`` in exposition format."""
    lines = []
    for fam in registry.collect():
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for child in fam.children():
            ls = _labels_str(fam.label_names, child.label_values)
            if fam.kind in (COUNTER, GAUGE):
                lines.append(
                    f"{fam.name}{ls} {_fmt_value(child.value)}"
                )
            elif fam.kind == HISTOGRAM:
                for le, cum in child.cumulative():
                    lle = _labels_str(
                        fam.label_names, child.label_values,
                        extra=(("le", _fmt_value(le)),),
                    )
                    lines.append(f"{fam.name}_bucket{lle} {cum}")
                lines.append(
                    f"{fam.name}_sum{ls} {_fmt_value(child.total)}"
                )
                lines.append(f"{fam.name}_count{ls} {child.count}")
            elif fam.kind == SUMMARY:
                for q, v in child.quantile_values():
                    if v is None:
                        continue
                    lq = _labels_str(
                        fam.label_names, child.label_values,
                        extra=(("quantile", _fmt_value(q)),),
                    )
                    lines.append(f"{fam.name}{lq} {_fmt_value(v)}")
                lines.append(
                    f"{fam.name}_sum{ls} {_fmt_value(child.total)}"
                )
                lines.append(f"{fam.name}_count{ls} {child.count}")
    return "\n".join(lines) + "\n"


def registry_snapshot(registry: MetricsRegistry) -> dict:
    """JSON-able view: counters/gauges as scalars, histograms and
    summaries as their snapshot dicts; labeled families nest by
    joined label values."""
    out = {}
    for fam in registry.collect():
        def _one(child):
            if fam.kind in (COUNTER, GAUGE):
                return child.value
            return child.snapshot()

        if not fam.label_names:
            out[fam.name] = _one(fam.children()[0])
        else:
            out[fam.name] = {
                ",".join(c.label_values): _one(c)
                for c in fam.children()
            }
    return out


def parse_format_query(path: str) -> "tuple[str, Optional[str]]":
    """Split an HTTP request path into (route, format) where format
    is the ``format=`` query value (None when absent) — shared by the
    serving and UI handlers so both speak ``/metrics?format=...``."""
    from urllib.parse import parse_qs, urlparse

    url = urlparse(path)
    fmt = parse_qs(url.query).get("format", [None])[0]
    return url.path, fmt
