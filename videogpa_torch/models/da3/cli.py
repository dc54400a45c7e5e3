"""DA3 command-line interface (``videogpa_tpu/models/da3/cli.py``).

The reference's typer app (``depth_anything_3/cli.py``) on argparse:
subcommands auto / image / images / video / backend / colmap / gallery, with
input-type autodetection, fps-based video frame sampling and the export
dispatch; the JAX CLI's flags, plus ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch versions) on the subcommands that run the model.

Usage: python -m videogpa_torch.models.da3.cli <command> [args]
(console script ``videogpa-torch-da3``).
"""

from __future__ import annotations

import argparse
import os
from typing import List

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}
VIDEO_EXTS = {".mp4", ".mov", ".avi", ".mkv", ".webm"}


def _load_model(model_dir: str, device=None):
    from videogpa_torch.models.loader import load_da3

    return load_da3(model_dir or "depth-anything/DA3-Large", device=device)[0]


def _pad14(img):
    import cv2

    h, w = img.shape[:2]
    # resize so the long side is 518 and both sides are /14-divisible
    scale = 518 / max(h, w)
    nh = max(14, round(h * scale / 14) * 14)
    nw = max(14, round(w * scale / 14) * 14)
    return cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)


def _run(frames, args):
    import numpy as np

    from videogpa_torch.models.da3.export import export
    from videogpa_torch.models.da3.model import da3_inference

    model = _load_model(args.model_dir, args.device)
    frames = np.stack([_pad14(f) for f in frames])
    pred = da3_inference(model, frames, return_features=args.export_format == "feat_vis")
    path = export(pred, args.export_format, args.out_dir, device=args.device)
    print(f"exported {args.export_format} -> {path}")
    return pred


def cmd_auto(args):
    ext = os.path.splitext(args.input)[1].lower()
    if os.path.isdir(args.input):
        return cmd_images(args)
    if ext in VIDEO_EXTS:
        return cmd_video(args)
    if ext in IMAGE_EXTS:
        return cmd_image(args)
    raise SystemExit(f"cannot autodetect input type of {args.input}")


def _read_images(paths: List[str]):
    import cv2

    return [cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB) for p in paths]


def cmd_image(args):
    return _run(_read_images([args.input]), args)


def cmd_images(args):
    if os.path.isdir(args.input):
        paths = sorted(os.path.join(args.input, f) for f in os.listdir(args.input)
                       if os.path.splitext(f)[1].lower() in IMAGE_EXTS)
    else:
        paths = args.input.split(",")
    return _run(_read_images(paths), args)


def cmd_video(args):
    import numpy as np

    from videogpa_torch.data.video_io import read_video_frames, video_frame_count

    total = video_frame_count(args.input)
    step = max(1, round(30 / args.fps))  # ~30 fps containers, as the reference assumes
    idx = np.arange(0, max(total, 1), step)[:args.max_frames]
    return _run(list(read_video_frames(args.input, idx)), args)


def cmd_backend(args):
    from videogpa_torch.models.da3.service import serve

    serve(model_dir=args.model_dir, host=args.host, port=args.port, device=args.device)


def cmd_colmap(args):
    """Pose-aligned inference on a COLMAP project (reference cli.py:471)."""
    import dataclasses

    import numpy as np

    from videogpa_torch.models.da3.colmap_io import load_colmap_scene
    from videogpa_torch.models.da3.export import export
    from videogpa_torch.models.da3.model import da3_inference

    files, extrinsics, _intrinsics = load_colmap_scene(args.input, args.sparse_subdir)
    frames = np.stack([_pad14(f) for f in _read_images(files)])
    model = _load_model(args.model_dir, args.device)
    if args.ref_view_strategy:
        cfg = dataclasses.replace(model.cfg, ref_view_strategy=args.ref_view_strategy)
        model.cfg = model.backbone.cfg = cfg
    pred = da3_inference(model, frames, gt_extrinsics=extrinsics[:, :3],
                         return_features=args.export_format == "feat_vis")
    path = export(pred, args.export_format, args.out_dir, device=args.device)
    print(f"exported {args.export_format} -> {path}")
    return pred


def cmd_gallery(args):
    """A gallery over an export directory. ``--serve``: the interactive
    two-level group/scene browser (``models/da3/gallery.py``, the reference's
    ``services/gallery.py`` server: manifest endpoints and a dependency-free
    point-cloud viewer page that parses the export glb in the browser).
    Default: a one-shot static HTML index (no server)."""
    if getattr(args, "serve", False):
        from videogpa_torch.models.da3.gallery import serve

        serve(args.input, host=args.host, port=args.port)
        return None
    import html

    root = args.input
    rows = []
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        rel = os.path.relpath(dirpath, root)
        arts = sorted(f for f in filenames if os.path.splitext(f)[1].lower()
                      in {".png", ".jpg", ".glb", ".ply", ".npz", ".mp4"})
        if arts:
            rows.append((rel, arts))
    items = []
    for rel, arts in rows:
        links = []
        for f in arts:
            href = html.escape(os.path.join(rel, f))
            if os.path.splitext(f)[1].lower() in {".png", ".jpg"}:
                links.append(f'<a href="{href}"><img src="{href}" '
                             f'style="max-height:160px;margin:4px"/></a>')
            else:
                links.append(f'<a href="{href}">{html.escape(f)}</a>')
        items.append(f"<section><h3>{html.escape(rel)}</h3>{' '.join(links)}</section>")
    page = ("<!doctype html><meta charset='utf-8'><title>DA3 gallery</title>"
            "<body style='font-family:sans-serif;max-width:1000px;margin:auto'>"
            f"<h1>DA3 exports: {html.escape(root)}</h1>" + "\n".join(items) + "</body>")
    out = os.path.join(root, "gallery.html")
    with open(out, "w") as f:
        f.write(page)
    print(f"gallery -> {out} ({len(rows)} scene dirs)")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="da3", description="Depth Anything 3 (PyTorch)")
    sub = parser.add_subparsers(dest="command", required=True)

    def device(p):
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    def common(p):
        p.add_argument("--model_dir", default=None)
        p.add_argument("--export_format", default="glb",
                       choices=["glb", "npz", "mini_npz", "ply", "colmap", "depth_vis",
                                "feat_vis"])
        p.add_argument("--out_dir", default="da3_out")
        device(p)

    for name, fn in [("auto", cmd_auto), ("image", cmd_image), ("images", cmd_images),
                     ("video", cmd_video)]:
        p = sub.add_parser(name)
        p.add_argument("input")
        common(p)
        if name in ("auto", "video"):
            p.add_argument("--fps", type=float, default=1.0)
            p.add_argument("--max_frames", type=int, default=100)
        p.set_defaults(fn=fn)

    p = sub.add_parser("backend")
    p.add_argument("--model_dir", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    device(p)
    p.set_defaults(fn=cmd_backend)

    p = sub.add_parser("colmap", help="pose-aligned inference on a COLMAP project")
    p.add_argument("input", help="dir with images/ and sparse/ subdirs")
    common(p)
    p.add_argument("--sparse_subdir", default="")
    p.add_argument("--ref_view_strategy", default="",
                   help="first | middle | saddle_balanced | saddle_sim_range")
    p.set_defaults(fn=cmd_colmap)

    p = sub.add_parser("gallery", help="browse exports: --serve for the interactive two-level "
                                       "group/scene server, default writes a static HTML index")
    p.add_argument("input", help="export root directory")
    p.add_argument("--serve", action="store_true", help="run the gallery HTTP server instead")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.set_defaults(fn=cmd_gallery)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
