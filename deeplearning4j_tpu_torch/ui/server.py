"""Browser training UI (reference ``deeplearning4j-play``:
``PlayUIServer.java:48`` — port 9000, overridable; ``TrainModule.java:1``
overview/model/system pages; ``HistogramModule`` per-layer param/update
charts; ``TsneModule`` embedding scatter; ``RemoteReceiverModule``
accepting remote-posted stats; ``RemoteUIStatsStorageRouter`` posting
them over HTTP).

Counterpart of ``deeplearning4j_tpu/ui/server.py``. The Play
framework is replaced by a stdlib ``http.server`` thread: JSON
endpoints + one self-contained page (inline SVG charts, no external
assets) with Overview / Histograms / Model / System / t-SNE sections
fed by the data StatsListener already records. The server binds
``DL4J_UI_PORT`` (default 9000; 0 picks a free port) on
``DL4J_UI_HOST`` (default loopback). ``/debugz`` and ``/train/system``
name the PyTorch and CUDA versions and the card; the page's t-SNE runs
on the CPU (``set_tsne_vectors``), so the UI thread never competes
with training for the card."""

from __future__ import annotations

import json
import logging
import os
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

from deeplearning4j_tpu_torch.observability.export import (
    CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE,
    parse_format_query,
    prometheus_text,
    registry_snapshot,
)
from deeplearning4j_tpu_torch.observability.metrics import default_registry
from deeplearning4j_tpu_torch.serving.envelope import (
    HttpBodyError,
    error_envelope,
    read_request_body,
)
from deeplearning4j_tpu_torch.ui.model import (
    StatsStorage,
    decode_record,
    StatsInitializationReport,
)

logger = logging.getLogger(__name__)

DEFAULT_PORT = 9000
PORT_ENV_VAR = "DL4J_UI_PORT"  # analog of org.deeplearning4j.ui.port
HOST_ENV_VAR = "DL4J_UI_HOST"  # set 0.0.0.0 to expose beyond loopback
MAX_POST_BYTES = 16 * 1024 * 1024  # /remoteReceive body cap

_PAGE = """<!DOCTYPE html>
<html><head><title>deeplearning4j_tpu_torch Training UI</title>
<style>
 body { font-family: sans-serif; margin: 2em; color: #222; }
 h1 { font-size: 1.3em; } h2 { font-size: 1.05em; }
 .card { border: 1px solid #ccc; border-radius: 6px; padding: 1em;
         margin-bottom: 1em; max-width: 860px; }
 table { border-collapse: collapse; }
 td, th { border: 1px solid #ddd; padding: 4px 10px; font-size: 0.9em; }
 svg { background: #fafafa; border: 1px solid #eee; }
 nav a { margin-right: 1em; cursor: pointer; color: #06c;
         text-decoration: underline; }
 select { margin-bottom: 0.6em; }
</style></head>
<body>
<h1>deeplearning4j_tpu_torch &mdash; Training UI</h1>
<nav>
 <a data-tab="overview">Overview</a><a data-tab="histograms">Histograms</a>
 <a data-tab="model">Model</a><a data-tab="graph">Graph</a>
 <a data-tab="system">System</a><a data-tab="activations">Activations</a>
 <a data-tab="tsne">t-SNE</a>
</nav>
<div id="tab-overview">
 <div class="card"><h2>Score vs. Iteration</h2>
  <svg id="chart" width="820" height="260"></svg></div>
</div>
<div id="tab-histograms" style="display:none">
 <div class="card"><h2>Parameter Histogram</h2>
  <select id="hkey"></select>
  <svg id="hist" width="820" height="220"></svg></div>
 <div class="card"><h2>Mean Magnitudes vs. Iteration</h2>
  <svg id="mm" width="820" height="220"></svg>
  <div id="mmlegend" style="font-size:0.85em"></div></div>
</div>
<div id="tab-model" style="display:none">
 <div class="card"><h2>Model</h2><table id="model"></table></div>
 <div class="card"><h2>Layers</h2><table id="layers"></table></div>
</div>
<div id="tab-system" style="display:none">
 <div class="card"><h2>System</h2><table id="system"></table></div>
 <div class="card"><h2>Host RSS (MB) vs. Iteration</h2>
  <svg id="rss" width="820" height="200"></svg></div>
</div>
<div id="tab-graph" style="display:none">
 <div class="card"><h2>Model Graph</h2>
  <svg id="modelgraph" width="820" height="480"></svg></div>
</div>
<div id="tab-activations" style="display:none">
 <div class="card"><h2>Conv Activations (latest snapshot)</h2>
  <div id="actgrids"></div></div>
</div>
<div id="tab-tsne" style="display:none">
 <div class="card"><h2>t-SNE Embedding</h2>
  <svg id="tsneplot" width="820" height="540"></svg>
  <p>POST JSON {"vectors": [[...]], "labels": [...]} to /tsne/post
     to (re)compute.</p></div>
</div>
<script>
const $ = (id) => document.getElementById(id);
document.querySelectorAll('nav a').forEach(a => a.onclick = () => {
  for (const t of ['overview','histograms','model','graph','system',
                   'activations','tsne'])
    $('tab-'+t).style.display = (t === a.dataset.tab) ? '' : 'none';
});
function drawGraph(svg, g) {
  svg.innerHTML = '';
  if (!g.nodes || !g.nodes.length) return;
  // layer nodes into columns by longest-path depth
  const depth = {}, incoming = {};
  g.nodes.forEach(n => { depth[n.name] = 0; incoming[n.name] = []; });
  g.edges.forEach(e => incoming[e.to] && incoming[e.to].push(e.from));
  for (let pass = 0; pass < g.nodes.length; pass++) {
    let changed = false;
    g.edges.forEach(e => {
      if (depth[e.from] !== undefined &&
          depth[e.to] < depth[e.from] + 1) {
        depth[e.to] = depth[e.from] + 1; changed = true;
      }
    });
    if (!changed) break;
  }
  const cols = {};
  g.nodes.forEach(n => {
    (cols[depth[n.name]] = cols[depth[n.name]] || []).push(n);
  });
  const W = +svg.getAttribute('width'), H = +svg.getAttribute('height');
  const nCols = Object.keys(cols).length;
  const pos = {};
  Object.entries(cols).forEach(([d, nodes]) => {
    nodes.forEach((n, i) => {
      pos[n.name] = {
        x: 30 + (W - 160) * (+d) / Math.max(nCols - 1, 1),
        y: 30 + (H - 70) * i / Math.max(nodes.length - 1, 1) *
           (nodes.length > 1 ? 1 : 0) + (nodes.length === 1 ? H/2-35 : 0),
      };
    });
  });
  const NS = 'http://www.w3.org/2000/svg';
  g.edges.forEach(e => {
    const a = pos[e.from], b = pos[e.to];
    if (!a || !b) return;
    const l = document.createElementNS(NS, 'line');
    l.setAttribute('x1', a.x + 110); l.setAttribute('y1', a.y + 15);
    l.setAttribute('x2', b.x); l.setAttribute('y2', b.y + 15);
    l.setAttribute('stroke', '#999');
    svg.append(l);
  });
  g.nodes.forEach(n => {
    const p = pos[n.name];
    const r = document.createElementNS(NS, 'rect');
    r.setAttribute('x', p.x); r.setAttribute('y', p.y);
    r.setAttribute('width', 110); r.setAttribute('height', 30);
    r.setAttribute('rx', 4);
    r.setAttribute('fill', n.type === 'input' ? '#def' : '#fff');
    r.setAttribute('stroke', '#06c');
    const t = document.createElementNS(NS, 'text');
    t.setAttribute('x', p.x + 55); t.setAttribute('y', p.y + 13);
    t.setAttribute('text-anchor', 'middle');
    t.setAttribute('font-size', 10);
    t.textContent = n.name;
    const t2 = document.createElementNS(NS, 'text');
    t2.setAttribute('x', p.x + 55); t2.setAttribute('y', p.y + 25);
    t2.setAttribute('text-anchor', 'middle');
    t2.setAttribute('font-size', 8); t2.setAttribute('fill', '#666');
    t2.textContent = n.type;
    svg.append(r, t, t2);
  });
}
function line(svg, xs, series, colors) {
  // series: [[y...], ...] multi-line chart with shared scale
  svg.innerHTML = '';
  const W = +svg.getAttribute('width'), H = +svg.getAttribute('height');
  const P = 34;
  const all = series.flat().filter(v => v !== null && isFinite(v));
  if (xs.length < 2 || !all.length) return;
  const xmin = Math.min(...xs), xmax = Math.max(...xs);
  const ymin = Math.min(...all), ymaxR = Math.max(...all);
  const ymax = ymaxR === ymin ? ymin + 1 : ymaxR;
  series.forEach((ys, si) => {
    const pts = xs.map((x, i) => [x, ys[i]])
      .filter(([x, y]) => y !== null && isFinite(y))  // skip null gaps
      .map(([x, y]) =>
      ((P + (x - xmin) / (xmax - xmin || 1) * (W - 2*P)) + ',' +
       (H - P - (y - ymin) / (ymax - ymin) * (H - 2*P)))).join(' ');
    const pl = document.createElementNS('http://www.w3.org/2000/svg',
                                        'polyline');
    pl.setAttribute('fill', 'none');
    pl.setAttribute('stroke', colors[si % colors.length]);
    pl.setAttribute('stroke-width', '1.5');
    pl.setAttribute('points', pts);
    svg.append(pl);
  });
  const t1 = document.createElementNS('http://www.w3.org/2000/svg','text');
  t1.setAttribute('x', 4); t1.setAttribute('y', 14);
  t1.setAttribute('font-size', 11); t1.textContent = ymaxR.toFixed(4);
  const t2 = document.createElementNS('http://www.w3.org/2000/svg','text');
  t2.setAttribute('x', 4); t2.setAttribute('y', H - 8);
  t2.setAttribute('font-size', 11); t2.textContent = ymin.toFixed(4);
  svg.append(t1, t2);
}
function bars(svg, h) {
  svg.innerHTML = '';
  if (!h || !h.counts || !h.counts.length) return;
  const W = +svg.getAttribute('width'), H = +svg.getAttribute('height');
  const P = 24, n = h.counts.length, cmax = Math.max(...h.counts) || 1;
  const bw = (W - 2*P) / n;
  h.counts.forEach((c, i) => {
    const r = document.createElementNS('http://www.w3.org/2000/svg','rect');
    const bh = (H - 2*P) * c / cmax;
    r.setAttribute('x', P + i*bw + 1); r.setAttribute('width', bw - 2);
    r.setAttribute('y', H - P - bh); r.setAttribute('height', bh);
    r.setAttribute('fill', '#06c');
    svg.append(r);
  });
  const t = document.createElementNS('http://www.w3.org/2000/svg','text');
  t.setAttribute('x', 4); t.setAttribute('y', H - 6);
  t.setAttribute('font-size', 11);
  t.textContent = h.min.toFixed(3) + ' .. ' + h.max.toFixed(3);
  svg.append(t);
}
const fill = (id, obj) => {
  const table = $(id);
  table.textContent = '';
  for (const [k, v] of Object.entries(obj || {})) {
    const tr = document.createElement('tr');
    const th = document.createElement('th');
    th.textContent = k;                  // textContent: no HTML
    const td = document.createElement('td');
    td.textContent = String(v);          // injection from records
    tr.append(th, td); table.append(tr);
  }
};
const COLORS = ['#06c','#c33','#2a2','#a3c','#f80','#088','#880'];
let histKey = null;
$('hkey').onchange = () => { histKey = $('hkey').value; };
async function refresh() {
  const sessions = await (await fetch('train/sessions')).json();
  if (!sessions.length) return;
  const sid = sessions[sessions.length - 1];
  const d = await (await fetch('train/overview?sid=' + sid)).json();
  line($('chart'), d.iterations, [d.scores], COLORS);
  fill('model', d.model); fill('system', d.system);

  const h = await (await fetch('train/histograms?sid=' + sid)).json();
  const keys = Object.keys(h.latest_histograms || {});
  const sel = $('hkey');
  if (sel.options.length !== keys.length) {
    sel.textContent = '';
    keys.forEach(k => {
      const o = document.createElement('option');
      o.value = k; o.textContent = k; sel.append(o);
    });
  }
  if (!histKey || !keys.includes(histKey)) histKey = keys[0];
  if (histKey) { sel.value = histKey; bars($('hist'),
                                          h.latest_histograms[histKey]); }
  const mmKeys = Object.keys(h.param_mean_magnitudes || {});
  line($('mm'), h.iterations,
       mmKeys.map(k => h.param_mean_magnitudes[k]), COLORS);
  $('mmlegend').textContent = mmKeys.map(
    (k, i) => k + ' (' + COLORS[i % COLORS.length] + ')').join('   ');

  const m = await (await fetch('train/model?sid=' + sid)).json();
  const lt = $('layers');
  lt.textContent = '';
  (m.layers || []).forEach(row => {
    const tr = document.createElement('tr');
    row.forEach(v => {
      const td = document.createElement('td');
      td.textContent = String(v); tr.append(td);
    });
    lt.append(tr);
  });

  const s = await (await fetch('train/system?sid=' + sid)).json();
  line($('rss'), s.iterations, [s.rss_mb], COLORS);

  const gr = await (await fetch('train/graph?sid=' + sid)).json();
  drawGraph($('modelgraph'), gr);

  const act = await (await fetch('train/activations')).json();
  const ag = $('actgrids');
  ag.textContent = '';
  for (const [layer, b64] of Object.entries(act.grids || {})) {
    const cap = document.createElement('div');
    cap.textContent = 'layer ' + layer;
    const img = document.createElement('img');
    img.src = 'data:image/png;base64,' + b64;
    img.style.imageRendering = 'pixelated';
    img.style.width = '640px';
    ag.append(cap, img);
  }

  const t = await (await fetch('train/tsne')).json();
  const svg = $('tsneplot');
  svg.innerHTML = '';
  if (t.coords && t.coords.length) {
    const W = 820, H = 540, P = 20;
    const xs = t.coords.map(c => c[0]), ys = t.coords.map(c => c[1]);
    const xmin = Math.min(...xs), xmax = Math.max(...xs) || xmin + 1;
    const ymin = Math.min(...ys), ymax = Math.max(...ys) || ymin + 1;
    t.coords.forEach((c, i) => {
      const g = document.createElementNS('http://www.w3.org/2000/svg',
                                         'circle');
      g.setAttribute('cx', P + (c[0]-xmin)/(xmax-xmin||1)*(W-2*P));
      g.setAttribute('cy', H - P - (c[1]-ymin)/(ymax-ymin||1)*(H-2*P));
      g.setAttribute('r', 3); g.setAttribute('fill', '#06c');
      svg.append(g);
      if (t.labels && t.labels[i] !== undefined) {
        const tx = document.createElementNS(
          'http://www.w3.org/2000/svg', 'text');
        tx.setAttribute('x', +g.getAttribute('cx') + 5);
        tx.setAttribute('y', +g.getAttribute('cy') + 4);
        tx.setAttribute('font-size', 10);
        tx.textContent = String(t.labels[i]);
        svg.append(tx);
      }
    });
  }
}
refresh(); setInterval(refresh, 2000);
</script></body></html>
"""


def _sanitize(obj):
    """NaN/Inf are not legal JSON and break the browser's JSON.parse —
    map them to null (a diverged score must not blank the UI)."""
    if isinstance(obj, float) and (obj != obj or obj in
                                   (float("inf"), float("-inf"))):
        return None
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


def _make_handler(server: "UIServer"):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, obj, code: int = 200):
            body = json.dumps(_sanitize(obj)).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path in ("/", "/train", "/train/overview.html"):
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if url.path == "/train/sessions":
                self._json(server.session_ids())
                return
            if url.path == "/train/overview":
                q = parse_qs(url.query)
                sid = q.get("sid", [None])[0]
                self._json(server.overview(sid))
                return
            if url.path == "/train/histograms":
                q = parse_qs(url.query)
                self._json(server.histograms(q.get("sid", [None])[0]))
                return
            if url.path == "/train/model":
                q = parse_qs(url.query)
                self._json(server.model_page(q.get("sid", [None])[0]))
                return
            if url.path == "/train/system":
                q = parse_qs(url.query)
                self._json(server.system_page(q.get("sid", [None])[0]))
                return
            if url.path == "/train/tsne":
                self._json(server.tsne_coords())
                return
            if url.path == "/train/graph":
                q = parse_qs(url.query)
                self._json(server.graph_page(q.get("sid", [None])[0]))
                return
            if url.path == "/train/activations":
                self._json(server.activations())
                return
            if url.path == "/debugz":
                try:
                    self._json(server.debug_snapshot())
                except Exception:
                    logger.exception("debugz failed")
                    self._json(error_envelope(
                        "debug_error", 500,
                        "debug snapshot failed; see server log",
                    ), 500)
                return
            if url.path == "/metrics":
                # training-side registry (TelemetryListener /
                # StatsListener publish here): JSON by default,
                # ?format=prometheus for scraping
                _, fmt = parse_format_query(self.path)
                if fmt == "prometheus":
                    body = prometheus_text(server.registry).encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     PROMETHEUS_CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._json(registry_snapshot(server.registry))
                return
            self._json(error_envelope("not_found", 404, "not found"),
                       404)

        def do_POST(self):
            path = urlparse(self.path).path
            if path == "/tsne/post":
                # shared body discipline with the serving tier:
                # 411 no Content-Length, 400 short read, 413 over cap
                try:
                    data = read_request_body(self, MAX_POST_BYTES)
                except HttpBodyError as e:
                    self._json(e.envelope, e.code)
                    return
                try:
                    payload = json.loads(data)
                    n = server.set_tsne_vectors(
                        payload["vectors"], payload.get("labels")
                    )
                except Exception as e:
                    self._json(error_envelope(
                        "bad_payload", 400, f"bad payload: {e}",
                    ), 400)
                    return
                self._json({"status": "ok", "points": n})
                return
            # RemoteReceiverModule analog: accept posted stats records
            if path != "/remoteReceive":
                self._json(error_envelope("not_found", 404,
                                          "not found"), 404)
                return
            if not server.remote_enabled:
                self._json(error_envelope(
                    "remote_disabled", 403, "remote receiver disabled",
                ), 403)
                return
            try:
                data = read_request_body(self, MAX_POST_BYTES)
            except HttpBodyError as e:
                self._json(e.envelope, e.code)
                return
            try:
                rec = decode_record(data)
            except Exception as e:
                self._json(error_envelope(
                    "bad_record", 400, f"bad record: {e}",
                ), 400)
                return
            storage = server.primary_storage()
            if isinstance(rec, StatsInitializationReport):
                storage.put_static_info(rec)
            else:
                storage.put_update(rec)
            self._json({"status": "ok"})

    return Handler


class UIServer:
    """Singleton UI server (reference ``UIServer.getInstance()`` /
    ``PlayUIServer``)."""

    _instance: Optional["UIServer"] = None
    _lock = threading.Lock()

    def __init__(self, port: Optional[int] = None,
                 host: Optional[str] = None):
        self.port = port if port is not None else int(
            os.environ.get(PORT_ENV_VAR, DEFAULT_PORT)
        )
        # default loopback-only: the remote receiver accepts
        # unauthenticated POSTs, so exposure must be an explicit choice
        self.host = host if host is not None else os.environ.get(
            HOST_ENV_VAR, "127.0.0.1"
        )
        self._storages: List[StatsStorage] = []
        self.remote_enabled = False
        # the process-wide training registry this server exports at
        # /metrics (StatsListener / TelemetryListener publish there)
        self.registry = default_registry()
        self._httpd = ThreadingHTTPServer(
            (self.host, self.port), _make_handler(self)
        )
        self.port = self._httpd.server_address[1]  # resolve port 0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="dl4j-torch-ui",
        )
        self._thread.start()

    @classmethod
    def get_instance(cls, port: Optional[int] = None) -> "UIServer":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(port)
            return cls._instance

    # -- reference API ---------------------------------------------------

    def attach(self, storage: StatsStorage) -> None:
        if storage not in self._storages:
            self._storages.append(storage)

    def detach(self, storage: StatsStorage) -> None:
        if storage in self._storages:
            self._storages.remove(storage)

    def enable_remote_listener(self) -> None:
        self.remote_enabled = True
        if not self._storages:
            self._storages.append(StatsStorage())

    def primary_storage(self) -> StatsStorage:
        if not self._storages:
            self._storages.append(StatsStorage())
        return self._storages[0]

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        with UIServer._lock:
            if UIServer._instance is self:
                UIServer._instance = None

    def debug_snapshot(self) -> dict:
        """``GET /debugz``: read-only, bounded first-responder page —
        versions, attached sessions, the training-side registry, the
        active profiler state, and the flight-recorder tail (capped at
        ``flightrec.DEBUG_TAIL_LIMIT``)."""
        import torch

        from deeplearning4j_tpu_torch import __version__ as pkg_version
        from deeplearning4j_tpu_torch.observability import (
            flightrec,
            profiler,
        )
        from deeplearning4j_tpu_torch.ui.stats_listener import (
            hardware_info,
        )

        out: dict = {
            "versions": {
                "deeplearning4j_tpu_torch": pkg_version,
                "torch": torch.__version__,
                "cuda": str(torch.version.cuda),
            },
            "backend": "cuda" if torch.cuda.is_available() else "cpu",
            "hardware": hardware_info(
                "cuda" if torch.cuda.is_available() else "cpu"),
            "config": {
                "port": self.port,
                "remote_enabled": self.remote_enabled,
            },
            "sessions": self.session_ids(),
            "metrics": registry_snapshot(self.registry),
        }
        prof = profiler.get_active_profiler()
        if prof is not None:
            out["profiler"] = prof.snapshot()
        rec = flightrec.get_flight_recorder()
        if rec is not None:
            out["flight_recorder"] = {
                "capacity": rec.capacity,
                "last_step": rec.last_step(),
                "tail": flightrec._jsonable(
                    rec.tail(flightrec.DEBUG_TAIL_LIMIT)
                ),
            }
        return out

    # -- data for the page ----------------------------------------------

    def session_ids(self) -> List[str]:
        out = []
        for s in self._storages:
            out += s.list_session_ids()
        return sorted(set(out))

    def overview(self, session_id: Optional[str]) -> dict:
        # honor the requested session across ALL storages before
        # falling back to any storage's latest
        ordered = self._storages
        if session_id is not None:
            exact = [s for s in self._storages
                     if session_id in s.list_session_ids()]
            if exact:
                ordered = exact
        for storage in ordered:
            sids = storage.list_session_ids()
            if not sids:
                continue
            sid = session_id if session_id in sids else sids[-1]
            workers = storage.list_workers(sid)
            if not workers:
                continue
            wid = workers[0]
            updates = storage.get_all_updates(sid, wid)
            static = storage.get_static_info(sid, wid)
            latest = updates[-1] if updates else None
            return {
                "session": sid,
                "iterations": [u.iteration for u in updates],
                "scores": [u.score for u in updates],
                "model": dict(static.model) if static else {},
                "system": {
                    **(dict(static.software) if static else {}),
                    **(dict(static.hardware) if static else {}),
                    **({"host_rss_mb":
                        round(latest.memory.get("host_rss_mb", 0), 1)}
                       if latest else {}),
                },
            }
        return {"session": None, "iterations": [], "scores": [],
                "model": {}, "system": {}}

    def _session_updates(self, session_id: Optional[str]):
        """(static, updates) for the requested/latest session."""
        ordered = self._storages
        if session_id is not None:
            exact = [s for s in self._storages
                     if session_id in s.list_session_ids()]
            if exact:
                ordered = exact
        for storage in ordered:
            sids = storage.list_session_ids()
            if not sids:
                continue
            sid = session_id if session_id in sids else sids[-1]
            workers = storage.list_workers(sid)
            if not workers:
                continue
            wid = workers[0]
            return (
                storage.get_static_info(sid, wid),
                storage.get_all_updates(sid, wid),
            )
        return None, []

    def histograms(self, session_id: Optional[str]) -> dict:
        """HistogramModule analog: latest per-param histograms +
        mean-magnitude series over iterations (reference
        ``HistogramModule.java``)."""
        _, updates = self._session_updates(session_id)
        iters = [u.iteration for u in updates]
        param_mm: dict = {}
        update_mm: dict = {}
        for u in updates:
            for k in u.param_mean_magnitudes:
                param_mm.setdefault(k, [])
            for k in u.update_mean_magnitudes:
                update_mm.setdefault(k, [])
        for u in updates:
            for k in param_mm:
                param_mm[k].append(u.param_mean_magnitudes.get(k))
            for k in update_mm:
                update_mm[k].append(u.update_mean_magnitudes.get(k))
        latest_h = {}
        for u in reversed(updates):
            if u.param_histograms:
                latest_h = u.param_histograms
                break
        return {
            "iterations": iters,
            "param_mean_magnitudes": param_mm,
            "update_mean_magnitudes": update_mm,
            "latest_histograms": latest_h,
        }

    def model_page(self, session_id: Optional[str]) -> dict:
        """TrainModule model-page analog: layer table + latest per-layer
        param magnitudes (reference ``TrainModule.java`` model tab)."""
        static, updates = self._session_updates(session_id)
        latest = updates[-1] if updates else None
        layer_rows = []
        if static is not None:
            names = (static.model.get("layers", "") or "").split(",")
            mm = latest.param_mean_magnitudes if latest else {}
            for name in names:
                if not name:
                    continue
                w = mm.get(f"{name}_W")
                b = mm.get(f"{name}_b")
                layer_rows.append([
                    name,
                    "-" if w is None else f"{w:.6f}",
                    "-" if b is None else f"{b:.6f}",
                ])
            if layer_rows:
                layer_rows.insert(0, ["layer", "mean|W|", "mean|b|"])
        return {
            "model": dict(static.model) if static else {},
            "layers": layer_rows,
        }

    def system_page(self, session_id: Optional[str]) -> dict:
        """TrainModule system-page analog: software/hardware + memory
        over time (reference system tab + ``StatsListener:310``)."""
        static, updates = self._session_updates(session_id)
        return {
            "iterations": [u.iteration for u in updates],
            "rss_mb": [
                u.memory.get("host_rss_mb") for u in updates
            ],
            "duration_ms": [u.duration_ms for u in updates],
            "software": dict(static.software) if static else {},
            "hardware": dict(static.hardware) if static else {},
        }

    def graph_page(self, session_id: Optional[str]) -> dict:
        """Model-graph page data (reference ``FlowListenerModule`` /
        TrainModule model tab): nodes + edges recorded by
        StatsListener's init report."""
        static, _ = self._session_updates(session_id)
        if static is None:
            return {"nodes": [], "edges": []}
        try:
            g = json.loads(static.model.get("graph_json", "{}"))
        except json.JSONDecodeError:
            g = {}
        return {"nodes": g.get("nodes", []),
                "edges": g.get("edges", [])}

    # -- conv activations (reference ConvolutionalListenerModule) --------

    def set_activations(self, grids: dict) -> None:
        """{layer_name: base64 PNG} from a
        ConvolutionalIterationListener."""
        self._activations = dict(grids)

    def activations(self) -> dict:
        return {"grids": getattr(self, "_activations", {})}

    # -- t-SNE module (reference TsneModule.java) ------------------------

    MAX_TSNE_POINTS = 2000
    MAX_TSNE_DIM = 1024

    def set_tsne_vectors(self, vectors, labels=None) -> int:
        """Accept vectors, compute 2-D coords (already-2-D input is
        stored as-is, matching the reference's upload of precomputed
        coordinates)."""
        import numpy as np

        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim != 2:
            raise ValueError("vectors must be 2-d [n, d]")
        if arr.shape[0] > self.MAX_TSNE_POINTS:
            raise ValueError(
                f"at most {self.MAX_TSNE_POINTS} points"
            )
        if arr.shape[1] > self.MAX_TSNE_DIM:
            raise ValueError(f"at most {self.MAX_TSNE_DIM} dims")
        if labels is not None and len(labels) != arr.shape[0]:
            raise ValueError("labels length mismatch")
        if arr.shape[1] == 2:
            coords = arr
        else:
            from deeplearning4j_tpu_torch.plot.tsne import Tsne

            n = arr.shape[0]
            perplexity = max(2.0, min(30.0, (n - 1) / 3.0))
            # host-side analytics: on the CPU, so the UI thread never
            # competes with training for the card
            tsne = Tsne(max_iter=250, perplexity=perplexity, seed=12345,
                        device="cpu")
            coords = tsne.fit(arr)
        self._tsne = {
            "coords": np.asarray(coords, np.float32).tolist(),
            "labels": list(labels) if labels is not None else None,
        }
        return arr.shape[0]

    def tsne_coords(self) -> dict:
        return getattr(self, "_tsne", {"coords": [], "labels": None})


class RemoteUIStatsStorageRouter:
    """HTTP POST router to a remote UI (reference
    ``RemoteUIStatsStorageRouter.java`` → ``RemoteReceiverModule``).
    Like the reference, transport failures never propagate into the
    training loop: failed posts are counted and, after
    ``max_consecutive_failures``, further sends are dropped with one
    warning (``retry_on_failure`` re-enables on the next success)."""

    def __init__(self, url: str, timeout: float = 5.0,
                 max_consecutive_failures: int = 10,
                 raise_on_error: bool = False):
        self.url = url.rstrip("/") + "/remoteReceive"
        self.timeout = timeout
        self.max_consecutive_failures = max_consecutive_failures
        self.raise_on_error = raise_on_error
        self._failures = 0
        self._disabled_logged = False

    def _post(self, rec) -> None:
        if self._failures >= self.max_consecutive_failures:
            if not self._disabled_logged:
                import logging

                logging.getLogger(__name__).warning(
                    "Remote stats routing disabled after %d consecutive "
                    "failures (target %s)", self._failures, self.url,
                )
                self._disabled_logged = True
            return
        req = urllib.request.Request(
            self.url, data=rec.encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(
                req, timeout=self.timeout
            ) as resp:
                resp.read()
            self._failures = 0
        except Exception:
            self._failures += 1
            if self.raise_on_error:
                raise

    def put_static_info(self, rec) -> None:
        self._post(rec)

    def put_update(self, rec) -> None:
        self._post(rec)
