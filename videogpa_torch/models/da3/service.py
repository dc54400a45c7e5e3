"""DA3 model-serving backend on the standard library's HTTP server
(``videogpa_tpu/models/da3/service.py``).

The reference's FastAPI backend (``depth_anything_3/services/backend.py:
96-201,1156-1368``): a resident model, a worker thread draining a task queue,
and the endpoints

    GET  /status          server and model state
    POST /infer           {"images": [b64 or path, ...], "export": "npz"}
                          {"video": path, "fps": 1.0, ...}
                          {"colmap": dir, "sparse_subdir": "", ...}
    GET  /tasks           task listing
    GET  /tasks/<id>      one task's state and result path
    GET  /memory          the device's memory (``utils.memory``)
    POST /reload          reload the weights

Finished tasks are dropped after a TTL, as the reference's (:392-457). A
task that raises ends as ``status: "error"`` with the message. The model
runs on ``device`` (the card unless the caller says "cpu"). Grad mode is
thread-local in PyTorch: the worker thread runs its tasks under its own
``torch.no_grad()``.
"""

from __future__ import annotations

import base64
import json
import os
import queue
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import torch

from videogpa_torch.device import resolve_device

TASK_TTL_SECONDS = 3600.0


def _sample_video_fps(video_path: str, fps: float = 1.0):
    """Frames of a video at ~fps frames a second -> (S, H, W, 3) uint8.

    The reference's VideoHandler: frame interval ``max(1, int(video_fps /
    fps))``; asking for more than the native rate decodes every frame
    (``services/input_handlers.py:221-286``). OpenCV's metadata stands in
    for ffprobe's (the same fields)."""
    import cv2
    import numpy as np

    from videogpa_torch.data.video_io import read_video_frames

    if not fps > 0:
        raise ValueError(f"fps must be > 0, got {fps}")
    if not os.path.exists(video_path):
        raise FileNotFoundError(f"video not found: {video_path}")
    cap = cv2.VideoCapture(video_path)
    try:
        video_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()
    interval = max(1, int(video_fps / fps))
    if total <= 0:
        return read_video_frames(video_path)[::interval]
    return read_video_frames(video_path, np.arange(0, total, interval))


class ModelBackend:
    """A resident DA3 and a background inference worker with a task queue."""

    def __init__(self, model_dir: Optional[str] = None, out_root: Optional[str] = None,
                 device=None):
        self.model_dir = model_dir
        self.device = resolve_device(device)
        self.out_root = out_root or tempfile.mkdtemp(prefix="da3_backend_")
        self.tasks: Dict[str, Dict[str, Any]] = {}
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._model = None
        self.started = time.time()
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()
        self._gc = threading.Thread(target=self._gc_loop, daemon=True)
        self._gc.start()

    # -- model ---------------------------------------------------------

    def _ensure_model(self):
        if self._model is None:
            from videogpa_torch.models.loader import load_da3

            self._model = load_da3(self.model_dir or "depth-anything/DA3-Large",
                                   device=self.device)[0]

    def reload(self):
        with self._lock:
            self._model = None
        self._ensure_model()

    # -- tasks ---------------------------------------------------------

    def submit(self, request: Dict[str, Any]) -> str:
        """Queue an inference request: one input source, ``images`` (base64
        or paths), ``video`` (a path and optional ``fps``) or ``colmap`` (a
        project directory and optional ``sparse_subdir``), and ``export``
        (the reference's input surface, ``services/input_handlers.py:66-286``)."""
        task_id = uuid.uuid4().hex[:12]
        self.tasks[task_id] = {"id": task_id, "status": "queued", "created": time.time(),
                               "export": request.get("export", "npz")}
        self._queue.put((task_id, request))
        return task_id

    def _resolve_input(self, request: Dict[str, Any]):
        """request -> (frames (S, H, W, 3) uint8, GT extrinsics or None)."""
        import numpy as np

        if request.get("images"):
            return np.stack([self._decode_image(i) for i in request["images"]]), None
        if request.get("video"):
            frames = _sample_video_fps(request["video"], float(request.get("fps", 1.0)))
            return np.stack([self._resize_14(f) for f in frames]), None
        if request.get("colmap"):
            from videogpa_torch.models.da3.colmap_io import load_colmap_scene

            files, extrinsics, _intrinsics = load_colmap_scene(
                request["colmap"], request.get("sparse_subdir", ""))
            return np.stack([self._decode_image(p) for p in files]), extrinsics
        raise ValueError("one of images/video/colmap required")

    def _drain(self):
        from videogpa_torch.models.da3.export import export
        from videogpa_torch.models.da3.model import da3_inference

        torch.set_grad_enabled(False)  # this thread's own grad mode
        while True:
            task_id, request = self._queue.get()
            task = self.tasks.get(task_id)
            if task is None:
                continue
            task["status"] = "running"
            try:
                self._ensure_model()
                frames, gt_extrinsics = self._resolve_input(request)
                pred = da3_inference(self._model, frames, gt_extrinsics=gt_extrinsics)
                out_dir = os.path.join(self.out_root, task_id)
                path = export(pred, request.get("export", "npz"), out_dir, device=self.device)
                task.update(status="done", result=path, n_frames=len(frames),
                            finished=time.time())
            except Exception as e:
                task.update(status="error", error=str(e), finished=time.time())

    @staticmethod
    def _decode_image(item: str):
        import cv2
        import numpy as np

        if os.path.exists(item):
            img = cv2.cvtColor(cv2.imread(item), cv2.COLOR_BGR2RGB)
        else:
            raw = np.frombuffer(base64.b64decode(item), np.uint8)
            img = cv2.cvtColor(cv2.imdecode(raw, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        return ModelBackend._resize_14(img)

    @staticmethod
    def _resize_14(img):
        """Resize so the long side is ~518 and both sides are /14-divisible."""
        import cv2

        h, w = img.shape[:2]
        scale = 518 / max(h, w)
        nh = max(14, round(h * scale / 14) * 14)
        nw = max(14, round(w * scale / 14) * 14)
        return cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)

    def _gc_loop(self):
        while True:
            time.sleep(60)
            now = time.time()
            stale = [tid for tid, t in list(self.tasks.items())
                     if t.get("finished") and now - t["finished"] > TASK_TTL_SECONDS]
            for tid in stale:
                self.tasks.pop(tid, None)

    # -- introspection -------------------------------------------------

    def status(self) -> dict:
        return {"status": "ok", "model_loaded": self._model is not None,
                "model_dir": self.model_dir, "device": str(self.device),
                "uptime_sec": round(time.time() - self.started, 1),
                "pending": self._queue.qsize(), "tasks": len(self.tasks)}

    def memory(self) -> dict:
        from videogpa_torch.utils.memory import get_device_memory_info

        return {str(self.device): get_device_memory_info(self.device)
                or {"memory_stats": "unavailable"}}


_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>DA3 backend</title>
<style>body{font-family:sans-serif;max-width:48em;margin:2em auto}
pre{background:#f4f4f4;padding:1em;overflow:auto}</style></head>
<body>
<h1>Depth Anything 3 — backend</h1>
<p>Pick images, submit for inference, poll the task below.</p>
<input type="file" id="files" multiple accept="image/*">
<select id="fmt"><option>npz</option><option>mini_npz</option><option>ply</option>
<option>glb</option><option>depth_vis</option><option>gs_ply</option></select>
<button onclick="run()">Infer</button>
<h3>Status</h3><pre id="status">-</pre>
<h3>Tasks</h3><pre id="tasks">-</pre>
<script>
async function refresh(){
  document.getElementById('status').textContent =
    JSON.stringify(await (await fetch('/status')).json(), null, 2);
  document.getElementById('tasks').textContent =
    JSON.stringify(await (await fetch('/tasks')).json(), null, 2);
}
async function run(){
  const files = document.getElementById('files').files;
  const imgs = [];
  for (const f of files){
    imgs.push(await new Promise(r => {
      const rd = new FileReader();
      rd.onload = () => r(rd.result.split(',')[1]);
      rd.readAsDataURL(f);
    }));
  }
  await fetch('/infer', {method:'POST', body: JSON.stringify(
    {images: imgs, export: document.getElementById('fmt').value})});
  refresh();
}
refresh(); setInterval(refresh, 3000);
</script></body></html>
"""


def make_handler(backend: ModelBackend):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                # a minimal browser page over the same endpoints (the
                # reference ships a gradio app)
                body = _INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return None
            if self.path == "/status":
                return self._send(200, backend.status())
            if self.path == "/memory":
                return self._send(200, backend.memory())
            if self.path == "/tasks":
                return self._send(200, {"tasks": list(backend.tasks.values())})
            if self.path.startswith("/tasks/"):
                task = backend.tasks.get(self.path.split("/")[-1])
                if task is None:
                    return self._send(404, {"error": "unknown task"})
                return self._send(200, task)
            return self._send(404, {"error": "unknown endpoint"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                return self._send(400, {"error": "invalid JSON"})
            if self.path == "/infer":
                if not any(payload.get(k) for k in ("images", "video", "colmap")):
                    return self._send(400, {"error": "one of images/video/colmap required"})
                if "fps" in payload:
                    try:
                        fps_ok = float(payload["fps"]) > 0
                    except (TypeError, ValueError):
                        fps_ok = False
                    if not fps_ok:
                        return self._send(400, {"error": "fps must be a number > 0"})
                return self._send(200, {"task_id": backend.submit(payload)})
            if self.path == "/reload":
                try:
                    backend.reload()
                    return self._send(200, {"status": "reloaded"})
                except Exception as e:
                    return self._send(500, {"error": str(e)})
            return self._send(404, {"error": "unknown endpoint"})

        def log_message(self, *args):  # quiet
            pass

    return Handler


def serve(model_dir: Optional[str] = None, host: str = "127.0.0.1", port: int = 8000,
          device=None):
    backend = ModelBackend(model_dir, device=device)
    server = ThreadingHTTPServer((host, port), make_handler(backend))
    print(f"DA3 backend listening on http://{host}:{port}")
    server.serve_forever()
