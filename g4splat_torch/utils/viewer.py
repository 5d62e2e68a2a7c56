"""Live network viewer (counterpart of `g4splat_tpu.utils.viewer`).

The reference's SIBR socket GUI (2d-gaussian-splatting/gaussian_renderer/
network_gui.py:12-97, polled from the training loop) as a small threaded
HTTP server that renders the current GaussianScene on request:

    GET /render?eye=x,y,z&target=x,y,z&w=512&h=384&fov=60&mode=rgb|depth|normal
    GET /info

`scene_provider()` is called per request, so `lambda: trainer.scene` shows
training as it goes. Each /render is one `render()` on the scene's device
(`backend="cuda"` by default: one B1 launch) and returns an 8-bit PNG; any
browser is the client. A failed render answers 500 with the error's text,
an unknown path 404. Port 0 binds an ephemeral port (`self.port` after
`start()`).
"""

from __future__ import annotations

import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from g4splat_torch.core.cameras import Camera, lookat_camera
from g4splat_torch.io.images import encode_png, to_uint8


def query_camera(q: Dict[str, List[str]], device) -> Camera:
    """The look-at camera of a /render query (eye, target, w, h, vertical
    fov in degrees; up is −y), on `device`."""
    eye = [float(v) for v in q.get("eye", ["0,0,-3"])[0].split(",")]
    target = [float(v) for v in q.get("target", ["0,0,0"])[0].split(",")]
    w = int(q.get("w", ["512"])[0])
    h = int(q.get("h", ["384"])[0])
    fov = float(q.get("fov", ["60"])[0])
    f = h / (2.0 * np.tan(np.radians(fov) / 2.0))
    return lookat_camera(eye, target, [0, -1, 0], fx=f, fy=f, width=w, height=h,
                         device=device)


class ViewerServer:
    def __init__(self, scene_provider: Callable, port: int = 6009, backend: str = "cuda"):
        self.scene_provider = scene_provider
        self.backend = backend
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @torch.no_grad()
    def _render(self, q) -> bytes:
        from g4splat_torch.ops.rasterize import render

        scene = self.scene_provider()
        out = render(query_camera(q, scene.device), scene, backend=self.backend)
        mode = q.get("mode", ["rgb"])[0]
        if mode == "depth":
            d = out["surf_depth"]
            img = (d / torch.clamp(d.max(), min=1e-6))[..., None].expand(*d.shape, 3)
        elif mode == "normal":
            img = out["rend_normal"] * 0.5 + 0.5
        else:
            img = out["render"]
        return encode_png(to_uint8(img))

    def _info(self) -> bytes:
        scene = self.scene_provider()
        return json.dumps({
            "n_alive": int(scene.num_alive),
            "capacity": int(scene.capacity),
            "sh_degree": int(scene.active_sh_degree),
        }).encode()

    def start(self) -> "ViewerServer":
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence
                pass

            def do_GET(self):
                try:
                    parsed = urlparse(self.path)
                    if parsed.path == "/render":
                        body = viewer._render(parse_qs(parsed.query))
                        ctype = "image/png"
                    elif parsed.path == "/info":
                        body = viewer._info()
                        ctype = "application/json"
                    else:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except Exception as e:  # noqa: BLE001 - the server keeps serving
                    traceback.print_exc()
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(f"{type(e).__name__}: {e}".encode())

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread:
            self._thread.join(timeout=10)
            self._thread = None
