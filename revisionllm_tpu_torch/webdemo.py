"""Browser demo server: video chat UI with token streaming, no gradio.

A copy of revisionllm_tpu/webdemo.py (it uses only the standard library).
Parity target: reference revisionllm/demo_gradio.py:120-148 (gr.Blocks app:
upload video -> extract features -> multi-turn chat with a TextStreamer),
as a self-contained stdlib HTTP server, so the demo needs no gradio:

  GET  /            one-page chat UI (vanilla JS, no external assets)
  POST /api/video   raw .npy (or video) bytes -> new ChatSession
  GET  /api/ask     Server-Sent Events stream of the growing answer
                    (the TextStreamer behavior, demo_gradio.py:133-141)
  POST /api/reset   drop chat history (new conversation, same video)

Run: `python -m revisionllm_tpu_torch.demo --web ...` (demo.py wires the
model), or construct DemoServer directly with any session factory; tests
inject a stub, so the HTTP surface is covered without model weights.
"""

from __future__ import annotations

import json
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>ReVisionLLM demo</title><style>
body{font-family:system-ui,sans-serif;max-width:760px;margin:2rem auto;padding:0 1rem}
#chat{border:1px solid #ccc;border-radius:8px;padding:1rem;min-height:260px;
      white-space:pre-wrap}
.q{color:#036;margin:.6em 0 .2em;font-weight:600}
.a{color:#222;margin:0 0 .6em}
#row{display:flex;gap:.5rem;margin-top:1rem}
#q{flex:1;padding:.5rem}
button{padding:.5rem 1rem}
#status{color:#666;font-size:.9em;margin:.5rem 0}
</style></head><body>
<h2>ReVisionLLM &mdash; video chat</h2>
<input type="file" id="file"> <button onclick="upload()">load video</button>
<button onclick="fetch('/api/reset',{method:'POST'}).then(()=>{
  document.getElementById('chat').innerHTML='';status('history cleared')})">reset</button>
<div id="status">no video loaded</div>
<div id="chat"></div>
<div id="row"><input id="q" placeholder="ask about the video"
  onkeydown="if(event.key==='Enter')ask()"><button onclick="ask()">send</button></div>
<script>
function status(t){document.getElementById('status').textContent=t}
async function upload(){
  const f=document.getElementById('file').files[0];
  if(!f){status('choose a file first');return}
  status('uploading + extracting features…');
  const r=await fetch('/api/video?name='+encodeURIComponent(f.name),
                      {method:'POST',body:await f.arrayBuffer()});
  status((await r.json()).status);
}
function ask(){
  const box=document.getElementById('q'),q=box.value.trim();
  if(!q)return; box.value='';
  const chat=document.getElementById('chat');
  const qd=document.createElement('div');qd.className='q';qd.textContent=q;
  const ad=document.createElement('div');ad.className='a';
  chat.appendChild(qd);chat.appendChild(ad);
  const es=new EventSource('/api/ask?q='+encodeURIComponent(q));
  es.onmessage=e=>{
    if(e.data==='[DONE]'){es.close();return}
    ad.textContent=JSON.parse(e.data);
    chat.scrollTop=chat.scrollHeight;
  };
  es.onerror=()=>es.close();
}
</script></body></html>"""


class DemoServer:
    """HTTP wrapper around a ChatSession factory.

    make_session(path) -> object with .ask_stream(q) yielding growing answer
    strings and a .history list (demo.ChatSession satisfies this; tests pass
    a stub). Model calls are serialized with a lock — one model call at a
    time, matching the single-queue gradio demo.
    """

    def __init__(
        self,
        make_session: Callable[[str], object],
        host: str = "127.0.0.1",
        port: int = 7860,
    ):
        self.make_session = make_session
        self.session: Optional[object] = None
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet test output
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    body = PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if url.path == "/api/ask":
                    q = parse_qs(url.query).get("q", [""])[0].strip()
                    if outer.session is None:
                        self._json(409, {"error": "upload a video first"})
                        return
                    if not q:
                        self._json(400, {"error": "empty question"})
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    with outer._lock:
                        for partial in outer.session.ask_stream(q):
                            self.wfile.write(
                                f"data: {json.dumps(partial)}\n\n".encode()
                            )
                            self.wfile.flush()
                    self.wfile.write(b"data: [DONE]\n\n")
                    return
                self._json(404, {"error": "not found"})

            def do_POST(self):
                url = urlparse(self.path)
                if url.path == "/api/video":
                    name = parse_qs(url.query).get("name", ["video.npy"])[0]
                    length = int(self.headers.get("Content-Length", "0"))
                    data = self.rfile.read(length)
                    suffix = "." + name.rsplit(".", 1)[-1] if "." in name else ""
                    try:
                        with tempfile.NamedTemporaryFile(
                            suffix=suffix, delete=False
                        ) as f:
                            f.write(data)
                            path = f.name
                        with outer._lock:
                            outer.session = outer.make_session(path)
                    except Exception as e:  # surface extraction errors to the UI
                        self._json(500, {"error": f"{type(e).__name__}: {e}"})
                        return
                    self._json(
                        200, {"status": f"video processed ({len(data)} bytes) — ask away"}
                    )
                    return
                if url.path == "/api/reset":
                    if outer.session is not None and hasattr(outer.session, "history"):
                        with outer._lock:
                            outer.session.history.clear()
                    self._json(200, {"status": "history cleared"})
                    return
                self._json(404, {"error": "not found"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def serve_forever(self):
        print(f"demo server on http://{self._httpd.server_address[0]}:{self.port}")
        self._httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def launch_web(make_session, host: str = "127.0.0.1", port: int = 7860):
    """Serve the demo. Defaults to loopback — the endpoint accepts arbitrary
    uploads with no auth, so exposing it externally requires an explicit
    host (e.g. launch_web(..., host="0.0.0.0"))."""
    DemoServer(make_session, host=host, port=port).serve_forever()
