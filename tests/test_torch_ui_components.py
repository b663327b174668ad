"""The port's UI component DSL (``deeplearning4j_tpu_torch/ui/
components.py``) against the JAX package's: for the same components,
``to_json`` and ``render_html`` (and ``render_page``) give the same
strings, and each package's JSON reads back in the other."""

import json

import pytest

from deeplearning4j_tpu.ui import components as jc
from deeplearning4j_tpu_torch.ui import components as pc


def _build(m):
    """One component of each kind, and a div nesting them, in module
    ``m`` (escaping, empty charts and odd numbers included)."""
    line = m.ChartLine(title="score <x>").add_series(
        "train", [0, 1, 2, 3], [2.5, 1.25, 0.7, 0.6125]).add_series(
        "test", [0, 2], [3.0, 1.0])
    scatter = m.ChartScatter(title="pts", width=300, height=200).add_series(
        "a", [0, 1, -1.5], [1, 0, 1e-9])
    hist = m.ChartHistogram(title="h").add_bin(0.0, 1.0, 5.0).add_bin(
        1.0, 2.5, 2.0).add_bin(2.5, 3.0, 0.0)
    empty = m.ChartHistogram(title="none")
    table = m.ComponentTable(header=["k", "v"],
                             content=[["a", "<script>"], ["b", 2]])
    text = m.ComponentText(text="<b>bold?</b> & more", font_size=14,
                           color="#111")
    div = m.ComponentDiv(children=[line, text, m.ComponentDiv(
        children=[table, hist], style="margin:1em")], style="x\"y")
    return [line, scatter, hist, empty, table, text, div,
            m.ChartLine(), m.ChartScatter()]


@pytest.mark.parametrize("i", range(9))
def test_to_json_and_render_html_equal_jax(i):
    got, ref = _build(pc)[i], _build(jc)[i]
    assert got.to_json() == ref.to_json()
    assert got.render_html() == ref.render_html()
    assert pc.render_page(got, "t <1>") == jc.render_page(ref, "t <1>")


@pytest.mark.parametrize("i", range(9))
def test_json_reads_back_in_the_other_package(i):
    p, j = _build(pc)[i], _build(jc)[i]
    assert pc.component_from_json(j.to_json()).to_json() == j.to_json()
    assert jc.component_from_json(p.to_json()).to_json() == p.to_json()
    assert json.loads(p.to_json())["component_type"] == type(p).__name__
