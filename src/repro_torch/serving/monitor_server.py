"""Dependency-free streaming endpoint for the trigger monitor (the
webserver half of the paper's §III-B visualization pipeline).

``MonitorServer`` serves, from a daemon thread on stdlib
``http.server`` only:

  ``/snapshot``   one JSON ``MonitorSnapshot`` (fleet view);
  ``/events``     NDJSON tail of the event-display ring
                  (``?n=K`` limits the tail length);
  ``/``           a self-contained HTML/SVG live event display that
                  polls the two endpoints — no external assets, so it
                  works on an air-gapped control-room machine.

The server only *reads* monitor state (snapshot/display aggregation
runs on its request threads, never on the serving hot path), so it can
be attached to a live ``ShardedTriggerService`` with bounded overhead.

The port of ``repro/serving/monitor_server.py``: the same endpoints, page
and JSON, over the port's monitor and service.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

__all__ = ["MonitorServer"]

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>trigger monitor</title>
<style>
 body{font:13px/1.4 monospace;background:#111;color:#ddd;margin:1em}
 table{border-collapse:collapse;margin-bottom:1em}
 td{border:1px solid #444;padding:2px 8px}
 svg{background:#181818;border:1px solid #444}
 .trig{fill:#ffb347}.notrig{fill:#5b9bd5}
</style></head><body>
<h3>real-time trigger monitor</h3>
<table id="stats"></table>
<svg id="disp" width="640" height="360"></svg>
<div id="cap"></div>
<script>
const FIELDS=["events","window_events","rate_ev_s","trigger_rate",
 "clusters_per_event","cluster_e_mean","latency_p50_us",
 "latency_p99_us","efficiency","fake_rate"];
function fmt(v){return v==null?"–":(typeof v=="number"?
 (Number.isInteger(v)?v:v.toPrecision(4)):v)}
async function tick(){
 try{
  const s=await (await fetch("snapshot")).json();
  document.getElementById("stats").innerHTML=FIELDS.map(
   k=>`<tr><td>${k}</td><td>${fmt(s[k])}</td></tr>`).join("");
  const txt=await (await fetch("events?n=1")).text();
  const lines=txt.trim().split("\\n").filter(x=>x);
  if(lines.length){
   const ev=JSON.parse(lines[lines.length-1]);
   const svg=document.getElementById("disp");
   const [nt,nph]=ev.grid||[56,156];
   const W=svg.getAttribute("width"),H=svg.getAttribute("height");
   svg.innerHTML=ev.clusters.map(c=>{
    const x=c.phi/nph*W, y=(1-c.theta/nt)*H,
          r=3+6*Math.min(1,c.energy);
    return `<circle cx="${x}" cy="${y}" r="${r}" `+
     `class="${ev.trigger?"trig":"notrig"}" opacity="${0.35+0.65*c.beta}">`+
     `<title>E=${c.energy.toFixed(3)} β=${c.beta.toFixed(2)}</title>`+
     `</circle>`}).join("");
   document.getElementById("cap").textContent=
    `event ${ev.event} · trigger=${ev.trigger}`+
    (("truth" in ev)?` · truth=${ev.truth}`:"")+
    ` · ${ev.clusters.length} cluster(s) · grid ${nt}×${nph}`;
  }
 }catch(e){/* service draining; keep polling */}
 setTimeout(tick,500);
}
tick();
</script></body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    # the snapshot/events callables are attached to the *server*
    # instance so one handler class serves any monitor.
    def _send(self, code: int, ctype: str, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        url = urlparse(self.path)
        try:
            if url.path in ("/", "/index.html", "/display"):
                self._send(200, "text/html; charset=utf-8",
                           _PAGE.encode())
            elif url.path == "/snapshot":
                snap = self.server.snapshot_fn()
                self._send(200, "application/json",
                           json.dumps(snap).encode())
            elif url.path == "/events":
                qs = parse_qs(url.query)
                n = int(qs["n"][0]) if "n" in qs else None
                recs = self.server.events_fn(n)
                body = "".join(json.dumps(r) + "\n" for r in recs)
                self._send(200, "application/x-ndjson", body.encode())
            else:
                self._send(404, "text/plain", b"not found\n")
        except BrokenPipeError:
            pass                       # client went away mid-reply
        except Exception as exc:  # noqa: BLE001 — a bad read must not
            try:                  # kill the serving process's thread
                self._send(500, "text/plain",
                           f"monitor error: {exc}\n".encode())
            except OSError:
                pass

    def log_message(self, *args):      # stay quiet on the hot console
        pass


class MonitorServer:
    """Serve a monitor (or monitored service) over HTTP.

    ``snapshot_fn`` returns a JSON-ready dict; ``events_fn(n)`` returns
    the last ``n`` (all when ``None``) event-display records.  Use
    ``MonitorServer.for_service(svc)`` to wire both to a
    ``ShardedTriggerService(monitor=...)``.  ``port=0`` binds an
    ephemeral port (read it back from ``.port``/``.url``).
    """

    def __init__(self, snapshot_fn, events_fn, *, port: int = 0,
                 host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.snapshot_fn = snapshot_fn
        self._httpd.events_fn = events_fn
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"monitor-server:{self.port}")
        self._thread.start()

    @classmethod
    def for_service(cls, service, *, port: int = 0,
                    host: str = "127.0.0.1") -> "MonitorServer":
        if not getattr(service, "monitoring", False):
            raise RuntimeError(
                "service has no monitors; construct it with "
                "monitor=True")
        return cls(service.monitor_snapshot, service.event_displays,
                   port=port, host=host)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
