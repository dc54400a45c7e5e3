"""Scoring CLI: write consistency scores into a prompt-group JSON
(``videogpa_tpu/cli/score.py``).

For every candidate video of ``data["groups"]`` run the reward scorer and
record ``consistency_score`` and ``motion_norm``; entries scored by an
earlier run are resumed, a failing clip is isolated (the reference protocol
of ``train/01_preference_pair.py``), and the JSON is saved atomically after
every group (batched path: after every chunk).

    python -m videogpa_torch.cli.score --input_json groups.json \
        --output_json scored.json --base_dir videos/ --batch_size 4

``--backbone da3`` scores with DA3 (``--model_name`` a DA3 checkpoint
directory, default ``depth-anything/DA3-Large``); ``--int8`` quantises
either backbone. The scorer runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

from videogpa_torch.data import video_io
from videogpa_torch.utils.json_io import safe_load_json, safe_save_json


def load_resume_map(output_json: str) -> Dict[str, Any]:
    """video_path -> (consistency_score, motion_norm) of every scored entry
    of an earlier run's output."""
    scored: Dict[str, Any] = {}
    if os.path.exists(output_json):
        prev = safe_load_json(output_json)
        for g in prev.get("groups", []):
            for v in g.get("videos", []):
                if "consistency_score" in v:
                    scored[v["video_path"]] = (v["consistency_score"], v.get("motion_norm", 0.0))
    return scored


def score_groups(processor, data: dict, output_json: str, base_dir: str = "",
                 num_frames: int = 10, thresholds=(0,), resume: bool = True,
                 batch_size: int = 1) -> dict:
    """Score every candidate video in data['groups'] in place; returns
    {"scored", "failed", "resumed"} counts.

    With batch_size > 1 pending clips are scored in fixed-size chunks through
    ``processor.process_frames_batch``, the next chunk decoding on one worker
    thread meanwhile; a chunk that fails is retried clip by clip from its
    files. With batch_size 1 clips are scored one a call, pipelined at depth
    2 (``process_frames_async``: clip i+1 is decoded and enqueued before
    clip i's scores are pulled); a clip whose asynchronous scoring fails is
    retried synchronously on the frames already decoded.
    """
    scored = load_resume_map(output_json) if resume else {}
    n_done = n_fail = n_skip = 0
    groups = data["groups"]
    th0 = thresholds[0]

    def apply_result(video, res):
        video["consistency_score"] = float(res[th0]["Consistency_Score"])
        video["motion_norm"] = float(res[th0]["motion_norm"])

    if batch_size > 1:
        from concurrent.futures import ThreadPoolExecutor

        pending = []  # (video dict, full path)
        for group in groups:
            for video in group.get("videos", []):
                vp_path = video["video_path"]
                if vp_path in scored:
                    video["consistency_score"], video["motion_norm"] = scored[vp_path]
                    n_skip += 1
                else:
                    full = os.path.join(base_dir, vp_path) if base_dir else vp_path
                    pending.append((video, full))
        chunks = [pending[c0:c0 + batch_size] for c0 in range(0, len(pending), batch_size)]

        def decode(chunk):
            return [video_io.sample_uniform_frames(p, n_frames=num_frames) for _, p in chunk]

        # decode chunk i+1 on a worker thread while chunk i runs on the device
        with ThreadPoolExecutor(max_workers=1) as prefetcher:
            fut = prefetcher.submit(decode, chunks[0]) if chunks else None
            for ci, chunk in enumerate(chunks):
                try:
                    frames = fut.result()
                except Exception as e:  # per-item isolation: retried clip by clip below
                    print(f"  chunk decode failed ({e}); retrying per clip")
                    frames = None
                # always advance the prefetch, whatever happened to chunk i
                fut = (prefetcher.submit(decode, chunks[ci + 1])
                       if ci + 1 < len(chunks) else None)
                batch_err = None
                if frames is not None:
                    try:
                        res_list = processor.process_frames_batch(frames, list(thresholds))
                        for (video, _), res in zip(chunk, res_list):
                            apply_result(video, res)
                        n_done += len(chunk)
                    except Exception as e:  # per-item isolation
                        batch_err = e
                if frames is None or batch_err is not None:
                    if batch_err is not None:
                        print(f"  batch failed ({batch_err}); retrying per clip")
                    for video, full in chunk:
                        try:
                            res = processor.process(full, thresholds=list(thresholds),
                                                    num_frames=num_frames)
                            apply_result(video, res)
                            n_done += 1
                        except Exception as e2:
                            print(f"  failed {video['video_path']}: {e2}")
                            n_fail += 1
                safe_save_json(data, output_json)
        return {"scored": n_done, "failed": n_fail, "resumed": n_skip}

    pending = None  # (video, vp_path, frames, result_fn)
    async_err_noted = False

    def note_async_error(e):
        # a systematic async-path failure (an unfusable metric set, or
        # VIDEOGPA_NO_FUSED_METRICS=1) sends every clip down the synchronous
        # path: say so once, with the error
        nonlocal async_err_noted
        if not async_err_noted:
            async_err_noted = True
            print(f"  async scoring unavailable ({e}); using the synchronous per-clip path")

    def drain(p):
        nonlocal n_done, n_fail
        video, vp_path, frames, result_fn = p
        try:
            apply_result(video, result_fn())
            n_done += 1
        except Exception as e:
            note_async_error(e)
            try:  # the decoded frames are host-side and not suspect: reuse them
                apply_result(video, processor.process_frames(frames, list(thresholds)))
                n_done += 1
            except Exception as e2:
                print(f"  failed {vp_path}: {e2}")
                n_fail += 1

    for group in groups:
        for video in group.get("videos", []):
            vp_path = video["video_path"]
            if vp_path in scored:
                video["consistency_score"], video["motion_norm"] = scored[vp_path]
                n_skip += 1
                continue
            full = os.path.join(base_dir, vp_path) if base_dir else vp_path
            frames = None
            try:
                frames = video_io.sample_uniform_frames(full, n_frames=num_frames)
                result_fn = processor.process_frames_async(frames, list(thresholds))
                if pending is not None:
                    drain(pending)
                pending = (video, vp_path, frames, result_fn)
            except Exception as e:  # per-item isolation (the reference's behaviour)
                if frames is not None:  # the decode succeeded; the async dispatch failed
                    note_async_error(e)
                if pending is not None:
                    drain(pending)
                    pending = None
                try:
                    if frames is None:  # the decode itself failed: retry from the file
                        res = processor.process(full, thresholds=list(thresholds),
                                                num_frames=num_frames)
                    else:  # reuse the decoded frames
                        res = processor.process_frames(frames, list(thresholds))
                    apply_result(video, res)
                    n_done += 1
                except Exception as e2:
                    print(f"  failed {vp_path}: {e2}")
                    n_fail += 1
        if pending is not None:
            drain(pending)
            pending = None
        safe_save_json(data, output_json)
    return {"scored": n_done, "failed": n_fail, "resumed": n_skip}


def main(argv=None) -> None:
    """``videogpa-torch-score``: the preference-pair scorer's command line
    (the reference's ``train/01_preference_pair.py`` surface). Returns
    nothing, as a console script's exit status is its return value; the
    ``score_groups`` counts are printed."""
    import argparse
    import time

    parser = argparse.ArgumentParser(prog="videogpa-torch-score")
    parser.add_argument("--input_json", required=True)
    parser.add_argument("--output_json", required=True)
    parser.add_argument("--base_dir", default="")
    parser.add_argument("--backbone", default=os.environ.get("VIDEO_PROCESSOR_BACKBONE", "vggt"))
    parser.add_argument("--model_name", default=None)
    parser.add_argument("--num_frames", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=1,
                        help="clips per device program (batched scoring)")
    parser.add_argument(
        "--int8", action="store_true",
        help="int8 scoring (W8A8 trunk GEMMs + int8-QK attention); it only ranks "
             "candidates, but validate its rankings on real checkpoints before use")
    parser.add_argument("--device", default="cuda",
                        help="where the scorer runs: cuda (default) or cpu")
    args = parser.parse_args(argv)

    from videogpa_torch.metrics import ConsistencyScore
    from videogpa_torch.models import loader
    from videogpa_torch.reward import VideoProcessor

    if args.backbone.lower() == "da3":
        params, cfg = loader.load_da3(args.model_name or "depth-anything/DA3-Large",
                                      device=args.device)
    else:
        params, cfg = loader.load_vggt(args.model_name or "facebook/VGGT-1B",
                                       device=args.device)
    attn_impl = "auto"
    if args.int8:
        from videogpa_torch.ops.quant import quantize_scorer_params

        params, attn_impl = quantize_scorer_params(args.backbone, params)
    vp = VideoProcessor({"Consistency_Score": ConsistencyScore(device=args.device)},
                        params=params, config=cfg, backbone=args.backbone,
                        attn_impl=attn_impl, device=args.device)
    data = safe_load_json(args.input_json)
    t0 = time.time()
    stats = score_groups(vp, data, args.output_json, base_dir=args.base_dir,
                         num_frames=args.num_frames, thresholds=[0],
                         batch_size=args.batch_size)
    hours = (time.time() - t0) / 3600
    print(f"Done in {hours:.2f} h ({stats}) -> {args.output_json}")


if __name__ == "__main__":
    main()
