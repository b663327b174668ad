"""UI component DSL (reference ``deeplearning4j-ui-components``: Java
bean components — ChartLine, ChartScatter, ChartHistogram,
ComponentTable, ComponentText, ComponentDiv — serialized to JSON and
rendered by TypeScript in the browser).

Counterpart of ``deeplearning4j_tpu/ui/components.py``, kept as its
own copy: the beans are dataclasses with the same JSON round trip
(``to_json`` / ``component_from_json``) plus a dependency-free
``render_html()`` that emits self-contained SVG/HTML, and both give
the JAX package's strings for the same component.
"""

from __future__ import annotations

import html
import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Type

_REGISTRY: Dict[str, Type] = {}


def _register(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


def component_from_json(s: str):
    d = json.loads(s) if isinstance(s, str) else s
    return _from_dict(d)


def _from_dict(d: dict):
    kind = d.pop("component_type")
    cls = _REGISTRY[kind]
    if cls is ComponentDiv:
        d["children"] = [_from_dict(c) for c in d.get("children", [])]
    return cls(**d)


class _Component:
    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def to_dict(self) -> dict:
        d = asdict(self)
        d["component_type"] = type(self).__name__
        return d

    def render_html(self) -> str:
        raise NotImplementedError


def _svg_axes(width, height, pad, xmin, xmax, ymin, ymax, title):
    parts = []
    if title:
        parts.append(
            f'<text x="{width // 2}" y="14" text-anchor="middle" '
            f'font-size="12">{html.escape(title)}</text>'
        )
    parts.append(
        f'<text x="4" y="{height - 4}" font-size="9">'
        f"{xmin:.3g}..{xmax:.3g}</text>"
    )
    parts.append(
        f'<text x="4" y="{pad + 8}" font-size="9">{ymax:.3g}</text>'
    )
    parts.append(
        f'<text x="4" y="{height - pad}" font-size="9">{ymin:.3g}</text>'
    )
    return parts


@_register
@dataclass
class ChartLine(_Component):
    """Multi-series line chart (reference ``ChartLine.java``)."""

    title: str = ""
    x: List[List[float]] = field(default_factory=list)
    y: List[List[float]] = field(default_factory=list)
    series_names: List[str] = field(default_factory=list)
    width: int = 640
    height: int = 300

    COLORS = ("#06c", "#c33", "#2a2", "#a3c", "#f80", "#088")

    def add_series(self, name: str, x: Sequence[float],
                   y: Sequence[float]) -> "ChartLine":
        self.series_names.append(name)
        self.x.append([float(v) for v in x])
        self.y.append([float(v) for v in y])
        return self

    def render_html(self) -> str:
        pad = 24
        allx = [v for s in self.x for v in s] or [0.0, 1.0]
        ally = [v for s in self.y for v in s] or [0.0, 1.0]
        xmin, xmax = min(allx), max(allx)
        ymin, ymax = min(ally), max(ally)
        xr = (xmax - xmin) or 1.0
        yr = (ymax - ymin) or 1.0
        parts = [
            f'<svg width="{self.width}" height="{self.height}" '
            f'xmlns="http://www.w3.org/2000/svg">'
        ]
        parts += _svg_axes(self.width, self.height, pad, xmin, xmax,
                           ymin, ymax, self.title)
        for si, (xs, ys) in enumerate(zip(self.x, self.y)):
            pts = " ".join(
                f"{pad + (x - xmin) / xr * (self.width - 2 * pad):.1f},"
                f"{self.height - pad - (y - ymin) / yr * (self.height - 2 * pad):.1f}"
                for x, y in zip(xs, ys)
            )
            color = self.COLORS[si % len(self.COLORS)]
            parts.append(
                f'<polyline fill="none" stroke="{color}" '
                f'stroke-width="1.5" points="{pts}"/>'
            )
        parts.append("</svg>")
        return "".join(parts)


@_register
@dataclass
class ChartScatter(_Component):
    """Scatter chart (reference ``ChartScatter.java``)."""

    title: str = ""
    x: List[List[float]] = field(default_factory=list)
    y: List[List[float]] = field(default_factory=list)
    series_names: List[str] = field(default_factory=list)
    width: int = 640
    height: int = 300

    def add_series(self, name, x, y) -> "ChartScatter":
        self.series_names.append(name)
        self.x.append([float(v) for v in x])
        self.y.append([float(v) for v in y])
        return self

    def render_html(self) -> str:
        pad = 24
        allx = [v for s in self.x for v in s] or [0.0, 1.0]
        ally = [v for s in self.y for v in s] or [0.0, 1.0]
        xmin, xmax = min(allx), max(allx)
        ymin, ymax = min(ally), max(ally)
        xr = (xmax - xmin) or 1.0
        yr = (ymax - ymin) or 1.0
        parts = [
            f'<svg width="{self.width}" height="{self.height}" '
            f'xmlns="http://www.w3.org/2000/svg">'
        ]
        parts += _svg_axes(self.width, self.height, pad, xmin, xmax,
                           ymin, ymax, self.title)
        for si, (xs, ys) in enumerate(zip(self.x, self.y)):
            color = ChartLine.COLORS[si % len(ChartLine.COLORS)]
            for x, y in zip(xs, ys):
                cx = pad + (x - xmin) / xr * (self.width - 2 * pad)
                cy = (
                    self.height - pad
                    - (y - ymin) / yr * (self.height - 2 * pad)
                )
                parts.append(
                    f'<circle cx="{cx:.1f}" cy="{cy:.1f}" r="2.5" '
                    f'fill="{color}"/>'
                )
        parts.append("</svg>")
        return "".join(parts)


@_register
@dataclass
class ChartHistogram(_Component):
    """Histogram chart (reference ``ChartHistogram.java``): bins as
    (lower, upper, value) triples."""

    title: str = ""
    lower: List[float] = field(default_factory=list)
    upper: List[float] = field(default_factory=list)
    values: List[float] = field(default_factory=list)
    width: int = 640
    height: int = 300

    def add_bin(self, lower: float, upper: float,
                value: float) -> "ChartHistogram":
        self.lower.append(float(lower))
        self.upper.append(float(upper))
        self.values.append(float(value))
        return self

    def render_html(self) -> str:
        pad = 24
        if not self.values:
            return (
                f'<svg width="{self.width}" height="{self.height}"/>'
            )
        xmin, xmax = min(self.lower), max(self.upper)
        vmax = max(self.values) or 1.0
        xr = (xmax - xmin) or 1.0
        parts = [
            f'<svg width="{self.width}" height="{self.height}" '
            f'xmlns="http://www.w3.org/2000/svg">'
        ]
        parts += _svg_axes(self.width, self.height, pad, xmin, xmax,
                           0.0, vmax, self.title)
        for lo, up, v in zip(self.lower, self.upper, self.values):
            x0 = pad + (lo - xmin) / xr * (self.width - 2 * pad)
            x1 = pad + (up - xmin) / xr * (self.width - 2 * pad)
            h = (v / vmax) * (self.height - 2 * pad)
            parts.append(
                f'<rect x="{x0:.1f}" y="{self.height - pad - h:.1f}" '
                f'width="{max(x1 - x0 - 1, 1):.1f}" height="{h:.1f}" '
                f'fill="#06c"/>'
            )
        parts.append("</svg>")
        return "".join(parts)


@_register
@dataclass
class ComponentTable(_Component):
    """Table (reference ``ComponentTable.java``)."""

    header: List[str] = field(default_factory=list)
    content: List[List[str]] = field(default_factory=list)

    def render_html(self) -> str:
        rows = []
        if self.header:
            rows.append(
                "<tr>" + "".join(
                    f"<th>{html.escape(str(h))}</th>" for h in self.header
                ) + "</tr>"
            )
        for row in self.content:
            rows.append(
                "<tr>" + "".join(
                    f"<td>{html.escape(str(c))}</td>" for c in row
                ) + "</tr>"
            )
        return (
            '<table border="1" style="border-collapse:collapse">'
            + "".join(rows) + "</table>"
        )


@_register
@dataclass
class ComponentText(_Component):
    """Styled text (reference ``ComponentText.java``)."""

    text: str = ""
    font_size: int = 12
    color: str = "#222"

    def render_html(self) -> str:
        return (
            f'<span style="font-size:{self.font_size}px;'
            f'color:{html.escape(self.color)}">'
            f"{html.escape(self.text)}</span>"
        )


@_register
@dataclass
class ComponentDiv(_Component):
    """Container (reference ``ComponentDiv.java``)."""

    children: List = field(default_factory=list)
    style: str = ""

    def to_dict(self) -> dict:
        return {
            "component_type": "ComponentDiv",
            "style": self.style,
            "children": [c.to_dict() for c in self.children],
        }

    def render_html(self) -> str:
        inner = "".join(c.render_html() for c in self.children)
        style = (
            f' style="{html.escape(self.style)}"' if self.style else ""
        )
        return f"<div{style}>{inner}</div>"


def render_page(component, title: str = "dl4j-tpu components") -> str:
    """Standalone HTML page around one component tree (reference:
    the component-renderer HTML scaffold)."""
    return (
        "<!DOCTYPE html><html><head><title>"
        + html.escape(title)
        + '</title></head><body style="font-family:sans-serif">'
        + component.render_html()
        + "</body></html>"
    )
