#!/bin/bash
set -e

# =============================================================
# VideoGPA replication on the PyTorch port (one NVIDIA GPU):
# generation (videogpa_torch.cli.replicate) + scoring
# (videogpa_torch.cli.replicate_scorer, DA3). Same flags as replicate.sh:
#   --mode dpo|sft|original   --lora_path PATH   --output_dir DIR
#   --prompt_json JSON        --dl3dv_dir DIR    --num_prompts N
#   --seeds S1,S2             --num_frames N
#   --skip_gen                --skip_score
# =============================================================

SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
MODE="dpo"
LORA_PATH="${SCRIPT_DIR}/checkpoints/VideoGPA-I2V-lora"
OUTPUT_DIR="${SCRIPT_DIR}/output/replicate"
PROMPT_JSON="${SCRIPT_DIR}/dl3dv_video_captions/captions_1K.json"
DL3DV_DIR="/datasets/DL3DV-10K"
NUM_PROMPTS="100"
SEEDS="456"
NUM_FRAMES="10"
SKIP_GEN=false
SKIP_SCORE=false

while [[ $# -gt 0 ]]; do
    case "$1" in
        --mode)        MODE="$2";        shift 2 ;;
        --lora_path)   LORA_PATH="$2";   shift 2 ;;
        --output_dir)  OUTPUT_DIR="$2";  shift 2 ;;
        --prompt_json) PROMPT_JSON="$2"; shift 2 ;;
        --dl3dv_dir)   DL3DV_DIR="$2";   shift 2 ;;
        --num_prompts) NUM_PROMPTS="$2"; shift 2 ;;
        --seeds)       SEEDS="$2";       shift 2 ;;
        --num_frames)  NUM_FRAMES="$2";  shift 2 ;;
        --skip_gen)    SKIP_GEN=true;    shift ;;
        --skip_score)  SKIP_SCORE=true;  shift ;;
        *) echo "unknown option $1"; exit 1 ;;
    esac
done

cd "${SCRIPT_DIR}"

if [ "$SKIP_GEN" = false ]; then
    echo "== Step 1: generation =="
    RUN_MODE="$MODE" RUN_LORA_PATH="$LORA_PATH" RUN_OUTPUT_DIR="$OUTPUT_DIR" \
    PROMPT_JSON="$PROMPT_JSON" DL3DV_BASE_DIR="$DL3DV_DIR" \
    RUN_NUM_PROMPTS="$NUM_PROMPTS" RUN_SEEDS="$SEEDS" \
    python -m videogpa_torch.cli.replicate
fi

if [ "$SKIP_SCORE" = false ]; then
    echo "== Step 2: scoring (backbone=da3) =="
    SCORE_BACKBONE="da3" SCORE_BASE_DIR="$OUTPUT_DIR" \
    SCORE_OUTPUT_CSV="$OUTPUT_DIR/scores.csv" \
    SCORE_NUM_FRAMES="$NUM_FRAMES" \
    SCORE_INT8="${SCORE_INT8:-0}" \
    python -m videogpa_torch.cli.replicate_scorer
fi

echo "Replication complete."
