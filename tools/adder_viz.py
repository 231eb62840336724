#!/usr/bin/env python
"""adder-viz equivalent: browser GUI over the headless transcoder/player.

ref: adder-viz/src/main.rs (egui app, Transcode + Play tabs;
transcoder/mod.rs splits params into live-tunable AdaptiveParams vs
relaunch-required CoreParams; transcoder/adder.rs publishes frames +
event-rate/bitrate/FPS plots). This environment has no display server, so
the GUI is a single-file web app: a stdlib HTTP server drives
models/live_transcoder.py or models/player.py on a worker thread and a
browser renders frames (PNG polling) plus live stat sparklines. The same
Adaptive/Core split applies: adaptive updates apply mid-stream, core
updates relaunch the source.

Usage:
  python tools/adder_viz.py --port 8080
  # then open http://localhost:8080, pick a file, Transcode or Play
"""

import argparse
import json
import pathlib
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

PAGE = """<!DOCTYPE html>
<html><head><title>adder-viz (web)</title><style>
body { font-family: system-ui, sans-serif; margin: 0; background: #191b1f; color: #e6e6e6; }
header { padding: 10px 16px; background: #22252a; display: flex; gap: 16px; align-items: center; }
header h1 { font-size: 16px; margin: 0; }
.tab { cursor: pointer; padding: 6px 14px; border-radius: 6px; background: #2c3036; }
.tab.active { background: #3b82f6; color: white; }
main { display: flex; gap: 16px; padding: 16px; }
#panel { width: 300px; display: flex; flex-direction: column; gap: 10px; }
label { font-size: 12px; color: #9aa2ad; display: block; margin-bottom: 2px; }
input, select, button { width: 100%; box-sizing: border-box; padding: 6px; border-radius: 6px;
  border: 1px solid #3a3f46; background: #22252a; color: #e6e6e6; }
button { background: #3b82f6; border: none; cursor: pointer; font-weight: 600; }
button.stop { background: #b91c1c; }
#view { flex: 1; } canvas, img { image-rendering: pixelated; background: #000; border-radius: 8px; }
#stats { display: grid; grid-template-columns: 1fr 1fr; gap: 8px; margin-top: 10px; }
.stat { background: #22252a; border-radius: 8px; padding: 8px; }
.stat .v { font-size: 18px; font-weight: 700; } .stat .k { font-size: 11px; color: #9aa2ad; }
.chart { margin-top: 8px; background: #22252a; border-radius: 8px; padding: 6px 8px 2px; }
.chart .t { font-size: 11px; color: #9aa2ad; display: flex; justify-content: space-between; }
.chart .t b { color: #e6e6e6; }
</style></head><body>
<header><h1>ADDER viz</h1>
  <div class="tab active" id="tab-t" onclick="setTab('transcode')">Transcode</div>
  <div class="tab" id="tab-p" onclick="setTab('play')">Play</div>
  <span id="status" style="color:#9aa2ad;font-size:12px"></span>
</header>
<main>
  <div id="panel">
    <div><label>Input path (mp4 for transcode, .adder for play)</label>
      <input id="path" placeholder="/path/to/input"></div>
    <div><label>CRF (0-9)</label><input id="crf" type="number" value="3" min="0" max="9"></div>
    <div><label>View mode</label><select id="view_mode">
      <option value="0">Intensity</option><option value="1">D</option>
      <option value="2">DeltaT</option><option value="3">SAE</option></select></div>
    <div><label>Feature detection</label><select id="features">
      <option value="off">Off</option><option value="instant">Instant</option>
      <option value="hold">Hold</option></select></div>
    <div><label>ROI (x0,y0,x1,y1; empty = none)</label><input id="roi"></div>
    <div><label>Quality metrics (PSNR/MSE vs source)</label><select id="quality">
      <option value="off">Off</option><option value="on">On</option></select></div>
    <div><label>delta_t_ref</label><input id="dtref" type="number" value="255"></div>
    <div><label>delta_t_max multiplier</label><input id="dtmult" type="number" value="30"></div>
    <div><label>Output .adder (transcode; empty = none)</label><input id="outpath"></div>
    <button onclick="start()">Start</button>
    <button class="stop" onclick="stop()">Stop</button>
    <div id="stats"></div>
    <div id="charts"></div>
  </div>
  <div id="view"><img id="frame" width="768"></div>
</main>
<script>
let tab = 'transcode';
function setTab(t) { tab = t;
  document.getElementById('tab-t').classList.toggle('active', t=='transcode');
  document.getElementById('tab-p').classList.toggle('active', t=='play'); }
function params() { return {
  tab: tab, path: val('path'), crf: +val('crf'), view_mode: +val('view_mode'),
  features: val('features'), roi: val('roi'), dtref: +val('dtref'),
  dtmult: +val('dtmult'), outpath: val('outpath'),
  quality: val('quality') == 'on' }; }
function val(id) { return document.getElementById(id).value; }
async function start() { await fetch('/api/start', {method:'POST', body: JSON.stringify(params())}); }
async function stop() { await fetch('/api/stop', {method:'POST'}); }
// live plot panel (adder-viz transcoder plots: event rate, bitrate,
// transcode FPS, quality — ref transcoder/mod.rs:64-73)
const PLOTS = [
  {key:'events_per_sec',  label:'events/s',  color:'#3b82f6', fmt:v=>v.toPrecision(4)},
  {key:'bitrate_bps',     label:'bitrate',   color:'#22c55e', fmt:v=>(v/1e6).toPrecision(4)+' Mb/s'},
  {key:'transcoded_fps',  label:'fps',       color:'#eab308', fmt:v=>v.toPrecision(4)},
  {key:'psnr',            label:'PSNR (dB)', color:'#ec4899', fmt:v=>v.toPrecision(4)},
];
const hists = {};
const chartsDiv = document.getElementById('charts');
for (const p of PLOTS) {
  hists[p.key] = [];
  chartsDiv.insertAdjacentHTML('beforeend',
    `<div class="chart" id="chart_${p.key}" style="display:none">
       <div class="t"><span>${p.label}</span><b id="cv_${p.key}"></b></div>
       <canvas id="cc_${p.key}" width="264" height="48"></canvas></div>`);
}
function drawPlots(stats) {
  for (const p of PLOTS) {
    const v = stats[p.key];
    const box = document.getElementById('chart_' + p.key);
    if (v === undefined || v === null) { continue; }
    box.style.display = '';
    const h = hists[p.key];
    h.push(v); if (h.length > 132) h.shift();
    document.getElementById('cv_' + p.key).textContent = p.fmt(v);
    const c = document.getElementById('cc_' + p.key).getContext('2d');
    c.clearRect(0,0,264,48); c.strokeStyle = p.color; c.beginPath();
    const mx = Math.max(...h, 1e-9), mn = Math.min(...h, 0);
    h.forEach((y,i) => { const px=i*2, py=46-44*(y-mn)/(mx-mn||1); i? c.lineTo(px,py): c.moveTo(px,py); });
    c.stroke();
  }
}
async function tick() {
  try {
    const s = await (await fetch('/api/stats')).json();
    document.getElementById('status').textContent = s.status;
    const entries = Object.entries(s.stats || {});
    document.getElementById('stats').innerHTML = entries.map(([k,v]) =>
      `<div class="stat"><div class="v">${typeof v=='number'? v.toPrecision(4): v}</div><div class="k">${k}</div></div>`).join('');
    if (s.stats) drawPlots(s.stats);
    if (s.running) document.getElementById('frame').src = '/api/frame?' + Date.now();
  } catch (e) {}
  setTimeout(tick, 500);
}
// live adaptive updates on change
for (const id of ['crf','view_mode','features','roi','quality'])
  document.getElementById(id).addEventListener('change', async () =>
    { await fetch('/api/adaptive', {method:'POST', body: JSON.stringify(params())}); });
tick();
</script></body></html>"""


class Session:
    """Worker-thread wrapper around LiveTranscoder / AdderPlayer."""

    def __init__(self):
        self.lock = threading.Lock()
        self.thread = None
        self.stop_flag = threading.Event()
        self.frame_png = None
        self.status = "idle"
        self.stats = {}
        self.obj = None
        self.kind = None

    def start(self, cfg: dict):
        self.stop()
        self.stop_flag.clear()
        self.kind = cfg["tab"]
        self.thread = threading.Thread(
            target=self._run, args=(cfg,), daemon=True
        )
        self.thread.start()

    def stop(self):
        self.stop_flag.set()
        if self.thread is not None:
            self.thread.join(timeout=10)
        self.thread = None
        self.status = "idle"

    def adaptive(self, cfg: dict):
        with self.lock:
            obj, kind = self.obj, self.kind
        if obj is None:
            return
        if kind == "transcode":
            from adder_jax.models.live_transcoder import AdaptiveParams
            from adder_jax.framer.scale_intensity import FramedViewMode
            from adder_jax.utils.viz import ShowFeatureMode
            from adder_jax.transcoder.video import Roi

            a = AdaptiveParams(
                crf=cfg["crf"],
                view_mode=FramedViewMode(cfg["view_mode"]),
                detect_features=cfg["features"] != "off",
                show_features={
                    "off": ShowFeatureMode.Off,
                    "instant": ShowFeatureMode.Instant,
                    "hold": ShowFeatureMode.Hold,
                }[cfg["features"]],
                roi=_parse_roi(cfg.get("roi", "")),
                quality_metrics=bool(cfg.get("quality")),
            )
            obj.update_adaptive(a)
        else:
            from adder_jax.framer.scale_intensity import FramedViewMode

            obj.set_view_mode(FramedViewMode(cfg["view_mode"]))

    def _encode(self, frame: np.ndarray):
        try:
            import cv2

            ok, buf = cv2.imencode(".png", frame)
            if ok:
                self.frame_png = buf.tobytes()
        except ImportError:
            pass  # frame preview needs cv2; stats still flow

    def _run(self, cfg):
        try:
            if cfg["tab"] == "transcode":
                self._run_transcode(cfg)
            else:
                self._run_play(cfg)
        except Exception as e:  # surfaced in the status line
            self.status = f"error: {e}"
        else:
            if not self.stop_flag.is_set():
                self.status = "finished"

    def _run_transcode(self, cfg):
        from adder_jax.codec.encoder import EncoderType
        from adder_jax.models.live_transcoder import (
            AdaptiveParams,
            CoreParams,
            LiveTranscoder,
        )

        core = CoreParams(
            input_path=cfg["path"],
            delta_t_ref=cfg["dtref"],
            delta_t_max_mult=cfg["dtmult"],
            encoder_type=(
                EncoderType.Raw if cfg.get("outpath") else EncoderType.Empty
            ),
            output_path=cfg.get("outpath") or None,
        )
        lt = LiveTranscoder(core, AdaptiveParams(crf=cfg["crf"]))
        lt.source.video._keep_running_frame = True
        with self.lock:
            self.obj = lt
        self.adaptive(cfg)
        self.status = "transcoding"
        while not self.stop_flag.is_set():
            out = lt.step()
            if out is None:
                break
            s = lt.stats
            self.stats = {
                "events_per_sec": s.events_per_sec,
                "events_ppc_per_sec": s.events_ppc_per_sec,
                "bitrate_bps": s.bitrate_bps,
                "transcoded_fps": s.transcoded_fps,
            }
            if s.psnr is not None:
                self.stats["psnr"] = s.psnr
                self.stats["mse"] = s.mse
            v = lt.source.video
            frame = (
                v.display_frame_features
                if v.show_features
                else v.running_intensities
            )
            self._encode(frame.squeeze())
        if core.output_path:
            lt.source.video.end_write_stream()

    def _run_play(self, cfg):
        from adder_jax.framer.scale_intensity import FramedViewMode
        from adder_jax.models.player import AdderPlayer

        pl = AdderPlayer(
            cfg["path"], view_mode=FramedViewMode(cfg["view_mode"])
        )
        with self.lock:
            self.obj = pl
        self.status = "playing"
        for frame in pl.frames(realtime=True, loop=True):
            if self.stop_flag.is_set():
                break
            s = pl.stats
            self.stats = {
                "events_per_sec": s.events_per_sec,
                "frames_emitted": s.frames_emitted,
                "bitrate_bps": s.bitrate_bps,
                "events_total": s.events_total,
            }
            self._encode(np.asarray(frame).squeeze())


def _parse_roi(s):
    from adder_jax.transcoder.video import Roi

    parts = [p for p in s.replace(" ", "").split(",") if p]
    if len(parts) != 4:
        return None
    x0, y0, x1, y1 = map(int, parts)
    return Roi(x0, y0, x1, y1)


SESSION = Session()


class Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _send(self, code, body, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/" or self.path.startswith("/index"):
            self._send(200, PAGE.encode(), "text/html")
        elif self.path.startswith("/api/stats"):
            self._send(200, json.dumps({
                "status": SESSION.status,
                "stats": SESSION.stats,
                "running": SESSION.thread is not None
                and SESSION.thread.is_alive(),
            }).encode())
        elif self.path.startswith("/api/frame"):
            png = SESSION.frame_png
            if png is None:
                self._send(404, b"{}")
            else:
                self._send(200, png, "image/png")
        else:
            self._send(404, b"{}")

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        cfg = json.loads(self.rfile.read(n) or b"{}")
        if self.path.startswith("/api/start"):
            SESSION.start(cfg)
        elif self.path.startswith("/api/stop"):
            SESSION.stop()
        elif self.path.startswith("/api/adaptive"):
            SESSION.adaptive(cfg)
        self._send(200, b"{}")


def main():
    ap = argparse.ArgumentParser(description="adder-viz web GUI")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args()
    srv = ThreadingHTTPServer((args.host, args.port), Handler)
    print(f"adder-viz: http://{args.host}:{args.port}")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        SESSION.stop()


if __name__ == "__main__":
    main()
