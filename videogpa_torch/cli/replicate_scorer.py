"""Scoring of the replicate flow's outputs (the root ``replicate_scorer.py``).

Configured by ``SCORE_*`` environment variables (``build_score_config``; DA3
is the default backbone) or by a dict passed to ``main``: scans
``<base_dir>/<prompt_id>/*.mp4`` (optionally only ``seed_<SCORE_SEED_FILTER>``
files, at most ``SCORE_MAX_VIDEOS``), resumes from the JSON report, scores
``SCORE_BATCH`` clips a device program (a chunk that fails is scored again
clip by clip, the reference's behaviour on a bad file), and writes one row a
video to a CSV and a JSON report with per-mode means.

    SCORE_BASE_DIR=output/replicate python -m videogpa_torch.cli.replicate_scorer

The scorer runs on the card unless ``main(device="cpu")``.
"""

from __future__ import annotations

import csv
import json
import os
from pathlib import Path
from typing import Mapping, Optional

DEFAULT_VGGT_MODEL = "facebook/VGGT-1B"
DEFAULT_DA3_MODEL = "depth-anything/DA3-Large"
METRIC_COLS = ["psnr", "ssim", "lpips", "mvcs", "consistency_score", "epipolar"]


def _bool(raw: Optional[str], default: bool) -> bool:
    if raw is None:
        return default
    return raw.strip().lower() in {"1", "true", "yes", "y", "on"}


def build_score_config(env: Optional[Mapping[str, str]] = None) -> dict:
    """The scorer's configuration from ``env`` (default ``os.environ``)."""
    env = os.environ if env is None else env
    backbone = env.get("SCORE_BACKBONE", "da3").strip().lower()
    default_model = DEFAULT_DA3_MODEL if backbone == "da3" else DEFAULT_VGGT_MODEL
    return {
        "base_dir": env.get("SCORE_BASE_DIR", "output/replicate"),
        "output_csv": env.get("SCORE_OUTPUT_CSV", "output/replicate/scores.csv"),
        "output_json": env.get("SCORE_OUTPUT_JSON", ""),
        "num_frames": int(env.get("SCORE_NUM_FRAMES", "10")),
        "conf_thres": int(env.get("SCORE_CONF_THRES", "0")),
        "ignore_seed": _bool(env.get("SCORE_IGNORE_SEED"), True),
        "descriptor_type": env.get("SCORE_DESCRIPTOR_TYPE", "sift"),
        "backbone": backbone,
        "model_name": env.get("SCORE_MODEL_NAME", default_model),
        "resume": _bool(env.get("SCORE_RESUME"), False),
        "max_videos": int(env.get("SCORE_MAX_VIDEOS", "0")),
        "seed_filter": env.get("SCORE_SEED_FILTER", ""),
        # clips a device program; 1 is the reference's per-video loop
        "score_batch": int(env.get("SCORE_BATCH", "1")),
        # int8 scoring (W8A8 trunk GEMMs + int8-QK attention); it only ranks
        # candidates, but validate its rankings on real checkpoints first
        "int8": _bool(env.get("SCORE_INT8"), False),
    }


def collect_tasks(cfg: dict) -> list:
    base = Path(cfg["base_dir"])
    tasks = []
    for prompt_dir in sorted(p for p in base.iterdir() if p.is_dir()):
        for mp4 in sorted(prompt_dir.glob("*.mp4")):
            if cfg["seed_filter"] and f"seed_{cfg['seed_filter']}" not in mp4.name:
                continue
            tasks.append({"prompt_id": prompt_dir.name, "path": str(mp4),
                          "relative_path": str(mp4.relative_to(base))})
    if cfg["max_videos"]:
        tasks = tasks[:cfg["max_videos"]]
    return tasks


def infer_mode(video_name: str) -> str:
    for mode in ("dpo", "sft", "original"):
        if f"_{mode}_" in video_name or video_name.endswith(f"_{mode}.mp4"):
            return mode
    return "unknown"


def build_summary(rows) -> dict:
    by_mode: dict = {}
    for row in rows:
        if row.get("error"):
            continue
        by_mode.setdefault(infer_mode(row["video_name"]), []).append(row)
    summary = {}
    for mode, items in by_mode.items():
        summary[mode] = {"count": len(items)}
        for col in METRIC_COLS + ["mse", "motion_score"]:
            vals = [r[col] for r in items if r.get(col) is not None]
            if vals:
                summary[mode][f"mean_{col}"] = sum(vals) / len(vals)
    return summary


def main(cfg: Optional[dict] = None, device=None) -> dict:
    """Score every task of ``cfg`` (default ``build_score_config()``) and
    write the CSV and the JSON report; returns the report."""
    from videogpa_torch.metrics import build_metrics
    from videogpa_torch.models import loader
    from videogpa_torch.reward import VideoProcessor

    cfg = build_score_config() if cfg is None else cfg
    if cfg["backbone"] == "da3":
        params, model_cfg = loader.load_da3(cfg["model_name"], device=device)
    else:
        params, model_cfg = loader.load_vggt(cfg["model_name"], device=device)
    attn_impl = "auto"
    if cfg["int8"]:
        from videogpa_torch.ops.quant import quantize_scorer_params

        params, attn_impl = quantize_scorer_params(cfg["backbone"], params)
    metrics = build_metrics(device=device, descriptor_type=cfg["descriptor_type"])
    vp = VideoProcessor(metrics, params=params, config=model_cfg, backbone=cfg["backbone"],
                        attn_impl=attn_impl, device=device)

    tasks = collect_tasks(cfg)
    print(f"{len(tasks)} videos to score (backbone={cfg['backbone']})")
    rows = []
    done_paths = set()
    out_json = cfg["output_json"] or cfg["output_csv"].replace(".csv", ".json")
    if cfg["resume"] and os.path.exists(out_json):
        with open(out_json) as f:
            rows = json.load(f).get("rows", [])
        done_paths = {r["video_path"] for r in rows}
        print(f"resuming: {len(rows)} already scored")

    def row_for(task):
        return {"prompt_id": task["prompt_id"], "video_name": os.path.basename(task["path"]),
                "video_path": task["path"], "relative_path": task["relative_path"],
                "backbone": cfg["backbone"]}

    def fill(row, res):
        row.update({
            "mse": float(res.get("MSE", 0.0)),
            "consistency_score": float(res.get("Consistency_Score", 0.0)),
            "motion_score": float(res.get("motion_norm", 0.0)),
            "psnr": float(res.get("PSNR", 0.0)),
            "ssim": float(res.get("SSIM", 0.0)),
            "lpips": float(res.get("LPIPS", 0.0)),
            "mvcs": float(res.get("MVCS", 0.0)),
            "epipolar": float(res.get("Epipolar", 0.0)),
        })

    def score_single(task):
        row = row_for(task)
        try:
            results = vp.process(task["path"], thresholds=[cfg["conf_thres"]],
                                 num_frames=cfg["num_frames"])
            fill(row, results.get(cfg["conf_thres"], {}))
        except Exception as e:  # per-video isolation (the reference's behaviour)
            print(f"failed {task['path']}: {e}")
            row["error"] = str(e)
            for col in METRIC_COLS:
                row.setdefault(col, None)
        return row

    pending = [t for t in tasks if t["path"] not in done_paths]
    B = max(1, cfg["score_batch"])
    done = 0
    for start in range(0, len(pending), B):
        chunk = pending[start:start + B]
        if len(chunk) > 1:
            # K clips a device program; a chunk that fails (a bad file) is
            # scored again clip by clip, so one file does not lose the batch
            try:
                batch_res = vp.process_paths([t["path"] for t in chunk],
                                             thresholds=[cfg["conf_thres"]],
                                             num_frames=cfg["num_frames"])
                for task, res in zip(chunk, batch_res):
                    row = row_for(task)
                    fill(row, res.get(cfg["conf_thres"], {}))
                    rows.append(row)
            except Exception as e:
                print(f"batch failed ({e}); retrying singly")
                rows.extend(score_single(t) for t in chunk)
        else:
            rows.extend(score_single(t) for t in chunk)
        done += len(chunk)
        if done % 10 < len(chunk):
            print(f"[{done}/{len(pending)}]")

    os.makedirs(os.path.dirname(os.path.abspath(cfg["output_csv"])), exist_ok=True)
    cols = (["prompt_id", "video_name", "video_path", "relative_path", "backbone", "mse",
             "consistency_score", "motion_score"] + METRIC_COLS + ["error"])
    with open(cfg["output_csv"], "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=cols, extrasaction="ignore")
        writer.writeheader()
        writer.writerows(rows)
    report = {"config": cfg, "rows": rows, "summary": build_summary(rows)}
    with open(out_json, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {cfg['output_csv']} and {out_json}")
    for mode, s in report["summary"].items():
        print(mode, {k: round(v, 4) for k, v in s.items() if isinstance(v, float)})
    return report


def cli() -> None:
    """``videogpa-torch-replicate-scorer``: ``main`` configured by the
    environment (a console script's exit status is its return value: None)."""
    main()


if __name__ == "__main__":
    cli()
