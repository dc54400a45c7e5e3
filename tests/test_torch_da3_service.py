"""The port's DA3 HTTP backend (``videogpa_torch/models/da3/service.py``) and
``da3`` CLI (``cli.py``) driven on the CPU with a tiny DA3 in place of
DA3-Large (``models.loader.load_da3`` monkeypatched): every endpoint
(``/``, ``/status``, ``/infer`` with images by path and base64, a video
sampled by fps and a COLMAP project, ``/tasks``, ``/tasks/<id>``,
``/memory``, ``/reload``, the 400s and 404s, a task that ends "error"), and
every subcommand with ``--device cpu``. Each artefact is held against the
port's ``da3_inference`` on the frames the JAX package's resize gives (the
image resize is the JAX package's, bit for bit). Mirrors
``tests/test_aux.py``'s ``TestServiceBackend`` and
``tests/test_da3_aux.py``'s CLI cases."""

import base64
import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from videogpa_tpu.models.da3 import cli as jcli
from videogpa_tpu.models.da3 import service as jservice
from videogpa_torch.data.video_io import write_video
from videogpa_torch.models import loader
from videogpa_torch.models.da3 import DA3Config, da3_inference, da3_init
from videogpa_torch.models.da3 import cli as tcli
from videogpa_torch.models.da3 import service as tservice

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    model = da3_init(DA3Config.tiny(), torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        model.cam_dec.fc_fov.bias += 1.0  # keep the random fov off 0
    return model.eval()


@pytest.fixture
def loads(tiny, monkeypatch):
    """``load_da3`` replaced by the tiny model; records each call's device."""
    calls = []

    def load_da3(name, cfg=None, dtype=torch.float32, device=None):
        calls.append(device)
        return tiny, tiny.cfg

    monkeypatch.setattr(loader, "load_da3", load_da3)
    return calls


def _images(root, n, h=10, w=30, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n):
        paths.append(os.path.join(root, f"im_{i}.png"))
        cv2.imwrite(paths[-1], rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return paths


def _expected(model, paths, resize, **kw):
    """The port's inference on the frames the JAX package's resize gives."""
    frames = np.stack([resize(cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)) for p in paths])
    return da3_inference(model, frames, **kw)


def _colmap_project(root, n):
    paths = _images(os.path.join(root, "images"), n, seed=3)
    os.makedirs(os.path.join(root, "sparse"))
    with open(os.path.join(root, "sparse", "cameras.txt"), "w") as f:
        f.write("1 PINHOLE 30 10 40 40 15 5\n")
    with open(os.path.join(root, "sparse", "images.txt"), "w") as f:
        for i in range(n):
            f.write(f"{i + 1} 1 0 0 0 {0.1 * i} 0 1 1 im_{i}.png\n\n")
    return paths


def test_backend_endpoints(tiny, loads, tmp_path):
    backend = tservice.ModelBackend(out_root=str(tmp_path / "out"), device="cpu")
    server = tservice.ThreadingHTTPServer(("127.0.0.1", 0), tservice.make_handler(backend))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        return json.loads(urllib.request.urlopen(base + path, timeout=30).read())

    def post(path, payload):
        data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        req = urllib.request.Request(base + path, data=data,
                                     headers={"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(req, timeout=60).read())

    def run(payload):
        tid = post("/infer", payload)["task_id"]
        for _ in range(600):
            task = get(f"/tasks/{tid}")
            if task["status"] in ("done", "error"):
                return task
            time.sleep(0.05)
        raise AssertionError(f"task {tid} did not finish: {task}")

    try:
        status = get("/status")
        assert status["status"] == "ok" and status["device"] == "cpu"
        assert not status["model_loaded"]
        page = urllib.request.urlopen(base + "/").read().decode()
        assert "Depth Anything 3" in page and "/infer" in page

        paths = _images(str(tmp_path / "imgs"), 2)
        want = _expected(tiny, paths, jservice.ModelBackend._resize_14)
        task = run({"images": paths, "export": "npz"})
        assert task["status"] == "done" and task["n_frames"] == 2, task
        got = np.load(task["result"])
        assert got["depth"].shape == (2, 168, 518)
        np.testing.assert_array_equal(got["depth"], want.depth)
        np.testing.assert_array_equal(got["extrinsics"], want.extrinsics)
        assert get("/status")["model_loaded"] and loads == [torch.device("cpu")]

        b64 = base64.b64encode(open(paths[0], "rb").read()).decode()
        task = run({"images": [b64], "export": "gs_ply"})
        assert task["status"] == "done" and task["result"].endswith("gaussians.ply"), task

        vid = str(tmp_path / "clip.mp4")
        write_video(vid, np.zeros((4, 10, 30, 3), np.uint8), fps=8)
        task = run({"video": vid, "fps": 4, "export": "mini_npz"})
        assert task["status"] == "done" and task["n_frames"] == 2, task  # 4 frames at 8 -> 4 fps

        proj = str(tmp_path / "scene")
        cpaths = _colmap_project(proj, 2)
        task = run({"colmap": proj, "export": "colmap"})
        assert task["status"] == "done" and task["n_frames"] == 2, task
        assert os.path.exists(os.path.join(task["result"], "images.txt"))

        task = run({"images": ["not-a-path-nor-an-image"], "export": "npz"})
        assert task["status"] == "error" and task["error"], task

        assert len(get("/tasks")["tasks"]) == 5
        assert get("/memory") == {"cpu": {"memory_stats": "unavailable"}}
        assert post("/reload", {}) == {"status": "reloaded"} and len(loads) == 2
        for path, payload, code in (("/infer", {}, 400), ("/infer", b"{not json", 400),
                                    ("/infer", {"video": vid, "fps": 0}, 400),
                                    ("/infer", {"video": vid, "fps": "nan"}, 400),
                                    ("/nowhere", {}, 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                post(path, payload)
            assert e.value.code == code, (path, payload)
        for path in ("/tasks/unknown", "/nowhere"):
            with pytest.raises(urllib.error.HTTPError) as e:
                get(path)
            assert e.value.code == 404
        assert len(cpaths) == 2
    finally:
        server.shutdown()
        server.server_close()


def test_backend_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tservice.ModelBackend()


def test_cli_subcommands_on_the_cpu(tiny, loads, tmp_path, monkeypatch):
    """images / image / auto / video / colmap / gallery / backend with
    ``--device cpu``; the exports against the port's inference on the
    frames of the JAX CLI's resize."""
    imgs = str(tmp_path / "imgs")
    paths = _images(imgs, 2, seed=1)
    out = str(tmp_path / "out")
    tcli.main(["images", imgs, "--export_format", "npz", "--out_dir", out, "--device", "cpu"])
    want = _expected(tiny, paths, jcli._pad14)
    got = np.load(os.path.join(out, "prediction.npz"))
    np.testing.assert_array_equal(got["depth"], want.depth)
    np.testing.assert_array_equal(got["intrinsics"], want.intrinsics)

    tcli.main(["auto", paths[0], "--export_format", "mini_npz", "--out_dir", out,
               "--device", "cpu"])
    want = _expected(tiny, paths[:1], jcli._pad14)
    got = np.load(os.path.join(out, "prediction_mini.npz"))
    np.testing.assert_array_equal(got["depth"], want.depth.astype(np.float16))

    vid = str(tmp_path / "clip.mp4")
    write_video(vid, np.full((5, 10, 30, 3), 90, np.uint8), fps=8)
    tcli.main(["video", vid, "--fps", "10", "--max_frames", "2", "--export_format", "npz",
               "--out_dir", str(tmp_path / "vid"), "--device", "cpu"])
    assert np.load(str(tmp_path / "vid" / "prediction.npz"))["depth"].shape == (2, 168, 518)

    proj = str(tmp_path / "scene")
    cpaths = _colmap_project(proj, 3)
    tcli.main(["colmap", proj, "--export_format", "npz", "--out_dir", str(tmp_path / "col"),
               "--ref_view_strategy", "middle", "--device", "cpu"])
    gt = np.stack([np.eye(4, dtype=np.float32)] * 3)
    gt[:, 0, 3], gt[:, 2, 3] = [0.0, 0.1, 0.2], 1.0  # images.txt's tvecs
    tiny.cfg = tiny.backbone.cfg = dataclasses.replace(DA3Config.tiny(),
                                                       ref_view_strategy="middle")
    try:
        want = _expected(tiny, cpaths, jcli._pad14, gt_extrinsics=gt[:, :3])
    finally:
        tiny.cfg = tiny.backbone.cfg = DA3Config.tiny()
    got = np.load(str(tmp_path / "col" / "prediction.npz"))
    np.testing.assert_array_equal(got["extrinsics"], want.extrinsics)
    assert set(loads) == {"cpu"} and len(loads) == 4

    with pytest.raises(SystemExit, match="autodetect"):
        tcli.main(["auto", str(tmp_path / "notes.txt"), "--device", "cpu"])

    tcli.main(["gallery", out])
    page = open(os.path.join(out, "gallery.html")).read()
    assert "prediction.npz" in page
    served = []
    monkeypatch.setattr("videogpa_torch.models.da3.gallery.serve",
                        lambda root, host, port: served.append((root, host, port)))
    tcli.main(["gallery", out, "--serve", "--port", "0"])
    assert served == [(out, "127.0.0.1", 0)]

    class _Server:
        def __init__(self, address, handler):
            served.append(address)

        def serve_forever(self):
            served.append("serving")

    monkeypatch.setattr(tservice, "ThreadingHTTPServer", _Server)
    tcli.main(["backend", "--port", "0", "--device", "cpu"])
    assert served[1:] == [("127.0.0.1", 0), "serving"]


def test_backend_under_concurrent_submissions(tiny, loads, tmp_path, monkeypatch):
    """48 requests from 8 client threads with a short switch interval, the
    model's inference replaced by a stub: every task gets its own id and
    ends done, with its own artefact."""
    import sys

    from videogpa_torch.models.da3 import DA3Prediction
    from videogpa_torch.models.da3 import model as model_mod

    def stub(model, frames, **kw):
        S, H, W, _ = frames.shape
        return DA3Prediction(depth=np.full((S, H, W), float(frames[0, 0, 0, 0]), np.float32),
                             conf=None, extrinsics=np.zeros((S, 3, 4), np.float32),
                             intrinsics=np.zeros((S, 3, 3), np.float32),
                             processed_images=frames.astype(np.float32))

    monkeypatch.setattr(model_mod, "da3_inference", stub)
    memory = {f"mem{i}": np.full((14, 14, 3), i, np.uint8) for i in range(48)}
    monkeypatch.setattr(tservice.ModelBackend, "_decode_image", staticmethod(memory.__getitem__))
    backend = tservice.ModelBackend(out_root=str(tmp_path), device="cpu")
    ids = {}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(c):
            for i in range(c, 48, 8):
                ids[i] = backend.submit({"images": [f"mem{i}"], "export": "mini_npz"})

        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        deadline = time.time() + 60
        while time.time() < deadline and not all(
                backend.tasks[t]["status"] == "done" for t in ids.values()):
            time.sleep(0.01)
    finally:
        sys.setswitchinterval(switch)
    assert len(set(ids.values())) == 48
    for i, tid in ids.items():
        task = backend.tasks[tid]
        assert task["status"] == "done", task
        assert np.load(task["result"])["depth"][0, 0, 0] == i
