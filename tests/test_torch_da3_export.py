"""The port's DA3 export pack and host modules against the JAX package's on
the same inputs: every exporter of ``videogpa_torch/models/da3/export.py``
(npz and mini_npz arrays equal; ply, glb, colmap and gs_ply headers, counts,
keys and dtypes identical and their floats within 1e-6 relative, since JAX
computes world points and quaternions in ``jnp``; feat_vis and depth_vis
byte for byte; gs_video's frames within one level), ``visualize.py`` bit
for bit, ``colmap_io.py`` (text and binary), ``data/input_processor.py``
and the gallery's manifests and HTTP endpoints. Mirrors ``tests/test_aux.py``'s
``TestExport``, ``TestInputProcessor`` and ``TestGSVideoExport``,
``tests/test_da3_aux.py``'s COLMAP, feat_vis and gallery cases and
``tests/test_da3_viz_utils.py``."""

import json
import struct
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from videogpa_tpu.data import input_processor as jinput
from videogpa_tpu.data import video_io as jvideo_io
from videogpa_tpu.models.da3 import colmap_io as jcolmap
from videogpa_tpu.models.da3 import export as jexport
from videogpa_tpu.models.da3 import gallery as jgallery
from videogpa_tpu.models.da3 import visualize as jvis
from videogpa_tpu.models.da3.model import DA3Prediction as JaxDA3Prediction
from videogpa_torch.data import input_processor as tinput
from videogpa_torch.data import video_io as tvideo_io
from videogpa_torch.models.da3 import DA3Prediction
from videogpa_torch.models.da3 import colmap_io as tcolmap
from videogpa_torch.models.da3 import export as texport
from videogpa_torch.models.da3 import gallery as tgallery
from videogpa_torch.models.da3 import visualize as tvis


def _arrays(S=2, H=28, W=28, seed=0):
    rng = np.random.default_rng(seed)
    E = np.tile(np.eye(4)[:3].astype(np.float32), (S, 1, 1))
    for s in range(S):
        q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        E[s, :, :3] = q * np.sign(np.linalg.det(q))
        E[s, :, 3] = rng.normal(size=3) * 0.5
    K = np.tile(np.array([[30.0, 0, W / 2], [0, 31.0, H / 2], [0, 0, 1]], np.float32), (S, 1, 1))
    return dict(depth=rng.uniform(1, 5, (S, H, W)).astype(np.float32),
                conf=rng.uniform(1, 2, (S, H, W)).astype(np.float32), extrinsics=E,
                intrinsics=K,
                processed_images=rng.uniform(0, 255, (S, H, W, 3)).astype(np.float32),
                features=rng.normal(size=(S, H // 14, W // 14, 16)).astype(np.float32))


def _pair(**kw):
    a = _arrays(**kw)
    return DA3Prediction(**a), JaxDA3Prediction(**a)


def _split_ply(raw: bytes):
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    return raw[:end], raw[end:]


def _close(got, want, rtol=1e-6):
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("fmt", ["npz", "mini_npz"])
def test_npz_exports_equal_jax(fmt, tmp_path):
    pred, jpred = _pair()
    got = np.load(texport.export(pred, fmt, str(tmp_path / "t")))
    want = np.load(jexport.export(jpred, fmt, str(tmp_path / "j")))
    assert set(got.files) == set(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("fmt", ["ply", "gs_ply"])
def test_ply_exports_match_jax(fmt, tmp_path):
    """Point cloud and the fallback gaussians (no Gaussian branch): the same
    header; the floats (world points from ``unproject_depth``) within 1e-6."""
    pred, jpred = _pair()
    got = open(texport.export(pred, fmt, str(tmp_path / "t")), "rb").read()
    want = open(jexport.export(jpred, fmt, str(tmp_path / "j")), "rb").read()
    (gh, gb), (wh, wb) = _split_ply(got), _split_ply(want)
    assert gh == wh and len(gb) == len(wb)
    assert f"element vertex {2 * 28 * 28}".encode() in gh
    if fmt == "gs_ply":
        _close(np.frombuffer(gb, "<f4"), np.frombuffer(wb, "<f4"))
    else:  # x y z float, r g b uchar
        rec = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
        g, w = np.frombuffer(gb, rec), np.frombuffer(wb, rec)
        np.testing.assert_array_equal(g["rgb"], w["rgb"])
        _close(g["xyz"], w["xyz"])


def _read_glb(path):
    raw = open(path, "rb").read()
    magic, version, total = struct.unpack_from("<III", raw, 0)
    assert (magic, version, total) == (0x46546C67, 2, len(raw))
    off, gltf, blob = 12, None, None
    while off + 8 <= len(raw):
        clen, ctype = struct.unpack_from("<II", raw, off)
        chunk = raw[off + 8:off + 8 + clen]
        if ctype == 0x4E4F534A:
            gltf = json.loads(chunk)
        elif ctype == 0x004E4942:
            blob = chunk
        off += 8 + clen

    def acc(i):
        a = gltf["accessors"][i]
        v = gltf["bufferViews"][a["bufferView"]]
        return np.frombuffer(blob, np.float32, count=a["count"] * 3,
                             offset=v.get("byteOffset", 0)).reshape(-1, 3)

    attrs = gltf["meshes"][0]["primitives"][0]["attributes"]
    return gltf, acc(attrs["POSITION"]), acc(attrs["COLOR_0"]), len(raw)


def test_glb_export_matches_jax(tmp_path):
    """The glb's JSON (but its generator name and the position bounds, which
    carry the points' last ulp), sizes and arrays; the cloud is the
    prediction's world points with y and z flipped, as the gallery's viewer
    reads them."""
    pred, jpred = _pair()
    g_json, g_pos, g_col, g_len = _read_glb(texport.export(pred, "glb", str(tmp_path / "t")))
    w_json, w_pos, w_col, w_len = _read_glb(jexport.export(jpred, "glb", str(tmp_path / "j")))
    assert g_json["asset"]["generator"] == "videogpa_torch"
    for j in (g_json, w_json):
        j["asset"].pop("generator")
        bounds = j["accessors"][0]
        bounds["min"], bounds["max"] = (np.asarray(bounds.pop(k)) for k in ("min", "max"))
    _close(g_json["accessors"][0]["min"], w_json["accessors"][0]["min"])
    _close(g_json["accessors"][0]["max"], w_json["accessors"][0]["max"])
    for j in (g_json, w_json):
        del j["accessors"][0]["min"], j["accessors"][0]["max"]
    assert g_json == w_json and g_len == w_len
    np.testing.assert_array_equal(g_col, w_col)
    _close(g_pos, w_pos)
    want = texport._world_points(pred).reshape(-1, 3) * np.array([1, -1, -1], np.float32)
    np.testing.assert_array_equal(g_pos, want)


def test_colmap_export_matches_jax(tmp_path):
    pred, jpred = _pair(S=3)
    got = texport.export(pred, "colmap", str(tmp_path / "t"))
    want = jexport.export(jpred, "colmap", str(tmp_path / "j"))
    for name in ("cameras.txt", "points3D.txt"):
        assert open(f"{got}/{name}").read() == open(f"{want}/{name}").read()
    g_lines = open(f"{got}/images.txt").read().splitlines()
    w_lines = open(f"{want}/images.txt").read().splitlines()
    assert len(g_lines) == len(w_lines) == 1 + 2 * 3
    for g, w in zip(g_lines, w_lines):
        gs, ws = g.split(), w.split()
        assert len(gs) == len(ws) and gs[8:] == ws[8:] and gs[:1] == ws[:1]
        if len(gs) > 1 and not g.startswith("#"):
            np.testing.assert_allclose(np.float64(gs[1:8]), np.float64(ws[1:8]), atol=1e-6)
    # the text model reads back through the port's reader as the same cameras
    cams, imgs, _ = tcolmap.read_model(got)
    for i, img in imgs.items():
        np.testing.assert_allclose(img.extrinsic[:3], pred.extrinsics[i - 1], atol=1e-6)
        np.testing.assert_allclose(cams[img.camera_id].K, pred.intrinsics[i - 1], atol=1e-5)


def test_feat_vis_and_depth_vis_equal_jax(tmp_path):
    """PCA feature maps and side-by-side depth jpgs, byte for byte (the same
    numpy, OpenCV and matplotlib code on the same prediction)."""
    pred, jpred = _pair()
    for fmt, names in (("feat_vis", ["feat_pca.npz", "feat_0000.png", "feat_0001.png"]),
                       ("depth_vis", ["0000.jpg", "0001.jpg"])):
        got = texport.export(pred, fmt, str(tmp_path / "t"))
        want = jexport.export(jpred, fmt, str(tmp_path / "j"))
        for n in names:
            assert open(f"{got}/{n}", "rb").read() == open(f"{want}/{n}", "rb").read(), n
    pred.features = None
    with pytest.raises(ValueError, match="return_features"):
        texport.export(pred, "feat_vis", str(tmp_path / "t"))
    with pytest.raises(ValueError, match="unknown export format"):
        texport.export(pred, "obj", str(tmp_path / "t"))


def test_gs_video_matches_jax(tmp_path, monkeypatch):
    """The fallback gaussians rendered along the smoothed trajectory: the
    frames each package hands its video writer agree within one level."""
    frames = {}

    def capture(tag):
        def write_video(path, f, fps=8):
            frames[tag] = (np.asarray(f), fps)
            open(path, "wb").write(b"mp4")
        return write_video

    monkeypatch.setattr(tvideo_io, "write_video", capture("t"))
    monkeypatch.setattr(jvideo_io, "write_video", capture("j"))
    a = _arrays(S=2, H=16, W=16)
    # rotations near the identity: the JAX package's smoothing writes into a
    # read-only array when a quaternion has to be flipped
    a["extrinsics"][:, :, :3] = np.eye(3, dtype=np.float32)
    a["extrinsics"][1, 0, 1], a["extrinsics"][1, 1, 0] = 0.05, -0.05
    a["depth"][:] = 2.0
    pred, jpred = DA3Prediction(**a), JaxDA3Prediction(**a)
    got = texport.export(pred, "gs_video", str(tmp_path / "t"), max_per_tile=64, device="cpu")
    jexport.export(jpred, "gs_video", str(tmp_path / "j"), max_per_tile=64)
    assert got.endswith("gs_smooth.mp4")
    (g, g_fps), (w, w_fps) = frames["t"], frames["j"]
    assert g.shape == w.shape == (2, 16, 16, 3) and g.dtype == w.dtype == np.uint8
    assert g_fps == w_fps == 24 and g.std() > 0
    assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


def test_visualize_matches_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.5, 10, (24, 32)).astype(np.float32)
    depth[:3] = 0  # invalid pixels stay at 0
    for kw in ({}, {"ret_type": np.float32}, {"ret_minmax": True}, {"percentile": 10}):
        got, want = tvis.visualize_depth(depth, **kw), jvis.visualize_depth(depth, **kw)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w)
    x = rng.uniform(0, 1, (2, 5, 6))
    np.testing.assert_array_equal(tvis.apply_color_map_to_image(x), jvis.apply_color_map_to_image(x))
    a, b = rng.uniform(0, 1, (3, 5, 7)), rng.uniform(0, 1, (3, 8, 4))
    for fn, kw in (("hcat", dict(align="center", gap=3, gap_color=[1, 0, 0])),
                   ("vcat", dict(align="end", gap=2)), ("hcat", dict(gap=0))):
        np.testing.assert_array_equal(getattr(tvis, fn)(a, b, **kw), getattr(jvis, fn)(a, b, **kw))
    np.testing.assert_array_equal(tvis.add_border(a, 4, [0, 1, 0]), jvis.add_border(a, 4, [0, 1, 0]))


def _write_binary_model(d):
    with open(d / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 64, 48))  # PINHOLE
        f.write(struct.pack("<4d", 60.0, 61.0, 32.0, 24.0))
        f.write(struct.pack("<iiQQ", 2, 0, 64, 48))  # SIMPLE_PINHOLE
        f.write(struct.pack("<3d", 55.0, 31.0, 23.0))
    with open(d / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        for img_id, cam_id, name in ((7, 1, b"b.png"), (3, 2, b"a.png")):
            f.write(struct.pack("<i", img_id))
            f.write(struct.pack("<4d", 0.9689124, 0.0, 0.2474040, 0.0))
            f.write(struct.pack("<3d", 0.5, -0.25, 2.0 + img_id))
            f.write(struct.pack("<i", cam_id))
            f.write(name + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<3d", 1.0, 2.0, -1))
            f.write(struct.pack("<3d", 3.0, 4.0, 11))
    with open(d / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<Q", 11))
        f.write(struct.pack("<3d", 0.1, 0.2, 0.3))
        f.write(struct.pack("<3B", 10, 20, 30))
        f.write(struct.pack("<d", 0.5))
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<2i", 7, 1))


@pytest.mark.parametrize("fmt", ["text", "binary"])
def test_colmap_reader_matches_jax(fmt, tmp_path):
    """A sparse model read by both packages, and ``load_colmap_scene``
    (sorted by name, images on disk only)."""
    import cv2

    sparse = tmp_path / "sparse" / "0"
    sparse.mkdir(parents=True)
    (tmp_path / "images").mkdir()
    if fmt == "binary":
        _write_binary_model(sparse)
    else:
        (sparse / "cameras.txt").write_text("# c\n1 PINHOLE 64 48 60 61 32 24\n"
                                            "2 SIMPLE_RADIAL 64 48 55 31 23 0.01\n")
        (sparse / "images.txt").write_text(
            "# i\n7 0.9689124 0 0.247404 0 0.5 -0.25 9 1 b.png\n1 2 -1 3 4 11\n"
            "3 1 0 0 0 0.1 0 1 2 a.png\n\n")
        (sparse / "points3D.txt").write_text("11 0.1 0.2 0.3 10 20 30 0.5 7 1\n")
    for name in ("a.png", "b.png"):
        cv2.imwrite(str(tmp_path / "images" / name), np.zeros((48, 64, 3), np.uint8))
    got, want = tcolmap.read_model(str(sparse)), jcolmap.read_model(str(sparse))
    for g_dict, w_dict in zip(got, want):
        assert g_dict.keys() == w_dict.keys()
        for k in w_dict:
            g, w = vars(g_dict[k]), vars(w_dict[k])
            assert g.keys() == w.keys()
            for f in w:
                np.testing.assert_array_equal(g[f], w[f], err_msg=f)
    for i in got[1]:
        np.testing.assert_array_equal(got[1][i].extrinsic, want[1][i].extrinsic)
        np.testing.assert_array_equal(got[0][got[1][i].camera_id].K,
                                      want[0][want[1][i].camera_id].K)
    g_scene = tcolmap.load_colmap_scene(str(tmp_path), "0")
    w_scene = jcolmap.load_colmap_scene(str(tmp_path), "0")
    assert g_scene[0] == w_scene[0] and g_scene[0][0].endswith("a.png")
    for g, w in zip(g_scene[1:], w_scene[1:]):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError):
        tcolmap.load_colmap_scene(str(tmp_path), "missing")


def test_input_processor_matches_jax(tmp_path):
    """``process_one`` under all four methods with intrinsics tracked, and the
    threaded ``InputProcessor`` on arrays and paths, bit for bit."""
    import cv2

    rng = np.random.default_rng(2)
    K = np.array([[500.0, 0, 180], [0, 480.0, 120], [0, 0, 1]])
    for h, w in ((240, 360), (377, 252)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for method in tinput.METHODS:
            for target in (518, 98):
                g_img, g_K = tinput.process_one(img, target, method, K)
                w_img, w_K = jinput.process_one(img, target, method, K)
                np.testing.assert_array_equal(g_img, w_img)
                np.testing.assert_array_equal(g_K, w_K)
                assert g_img.shape[1] % 14 == 0 and g_img.shape[2] % 14 == 0
    with pytest.raises(ValueError, match="Unsupported"):
        tinput.process_one(img, 518, "nearest")
    imgs = [rng.integers(0, 256, (100, 150, 3), dtype=np.uint8) for _ in range(2)]
    path = str(tmp_path / "im.png")
    cv2.imwrite(path, cv2.cvtColor(imgs[0], cv2.COLOR_RGB2BGR))
    items = imgs + [path]
    g_batch, g_Ks = tinput.InputProcessor(num_workers=2)(items, 98)
    w_batch, w_Ks = jinput.InputProcessor(num_workers=2)(items, 98)
    np.testing.assert_array_equal(g_batch, w_batch)
    assert g_Ks == w_Ks == [None] * 3 and tinput.InputAdapter is tinput.InputProcessor


def _gallery_tree(root):
    import cv2

    for group, scenes in (("kitchens", ["s01", "s02"]), ("parks", ["p01"])):
        for s in scenes:
            d = root / group / s
            (d / "depth_vis").mkdir(parents=True)
            (d / "scene.glb").write_bytes(b"glTF-fake")
            cv2.imwrite(str(d / "scene.jpg"), np.zeros((6, 12, 3), np.uint8))
            for i in range(3):
                cv2.imwrite(str(d / "depth_vis" / f"d{i:03d}.png"), np.zeros((4, 4, 3), np.uint8))
    (root / "kitchens" / "broken").mkdir()  # no glb: skipped
    (root / "empty_group").mkdir()


# the reference's drag handler never hears pointercancel; the port's does
_JAX_UP = """      cv.removeEventListener('pointerup', up);
    };
    cv.addEventListener('pointermove', mv);
    cv.addEventListener('pointerup', up);
"""
_PORT_UP = """      cv.removeEventListener('pointerup', up);
      cv.removeEventListener('pointercancel', up);
    };
    cv.addEventListener('pointermove', mv);
    cv.addEventListener('pointerup', up);
    cv.addEventListener('pointercancel', up);
"""


def _port_page(page):
    """The JAX package's gallery page with the port's two changes."""
    assert page.count(_JAX_UP) == 1
    return page.replace("air-gapped TPU hosts", "air-gapped hosts").replace(_JAX_UP, _PORT_UP)


def test_gallery_drag_ends_on_pointercancel(tmp_path):
    """A drag the browser cancels ends as one released: the served page's
    script registers ``up`` for pointerup and pointercancel and removes
    both, so no pointermove listener outlives the gesture."""
    import re

    server = tgallery.make_server(str(tmp_path), port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        page = urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/",
                                      timeout=5).read().decode()
    finally:
        server.shutdown()
        server.server_close()
    handler = page[page.index("cv.addEventListener('pointerdown'"):]
    handler = handler[:handler.index("cv.addEventListener('wheel'")]
    for ev in ("pointerup", "pointercancel"):
        assert re.search(rf"cv\.addEventListener\('{ev}', up\)", handler), ev
        assert re.search(rf"cv\.removeEventListener\('{ev}', up\)", handler), ev
    up = handler[handler.index("const up = () => {"):]
    up = up[:up.index("};")]
    assert "removeEventListener('pointermove', mv)" in up
    assert "pointercancel" not in jgallery.GALLERY_PAGE  # the reference's copy stays


def test_gallery_manifests_and_server_match_jax(tmp_path):
    _gallery_tree(tmp_path)
    assert tgallery.build_group_list(str(tmp_path)) == jgallery.build_group_list(str(tmp_path))
    for g in ("kitchens", "parks", "nope"):
        assert (tgallery.build_group_manifest(str(tmp_path), g)
                == jgallery.build_group_manifest(str(tmp_path), g))
    assert tgallery.GALLERY_PAGE == _port_page(jgallery.GALLERY_PAGE)
    server = tgallery.make_server(str(tmp_path), port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        def get(path):
            return urllib.request.urlopen(base + path, timeout=5)

        page = get("/").read().decode()
        assert "parseGlbPoints" in page and "https://" not in page
        assert [g["id"] for g in json.loads(get("/manifest.json").read())["groups"]] == [
            "kitchens", "parks"]
        assert len(json.loads(get("/manifest/kitchens.json").read())["items"]) == 2
        r = get("/kitchens/s01/scene.glb")
        assert r.read() == b"glTF-fake" and r.headers["Content-Type"] == "model/gltf-binary"
        for bad, code in (("/manifest/..%2fkitchens.json", 400), ("/kitchens/", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                get(bad)
            assert e.value.code == code
    finally:
        server.shutdown()
        server.server_close()
