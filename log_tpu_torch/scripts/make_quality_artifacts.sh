#!/bin/bash
# The quality artifacts of a finished config/synthetic_conv run through the
# port's CLI; counterpart of scripts/make_quality_artifacts.sh:
#   * the val split of the final checkpoint (gt / renders PNG pairs, PSNR);
#   * demo_interpolate (timed frames, jpg frames; an mp4 where ffmpeg is);
#   * curated copies under output/quality_artifacts (nothing is committed).
# The run's scene must be the one it trained on: pass the same overrides
# (root, PLYNAME, dataset.args.ext, ...) after the exp dir.
#
# Usage: bash log_tpu_torch/scripts/make_quality_artifacts.sh [exp_dir]
#            [--device cuda|cpu] [key value ...]
set -uo pipefail
cd "$(dirname "$0")/../.."

EXP=${1:-output/synthetic_conv/log}
shift || true
CFG=config/synthetic_conv/train.yml
CKPT="$EXP/model_tree_full.pth"
[ -f "$CKPT" ] || { echo "missing $CKPT"; exit 1; }

echo "=== val split (final checkpoint)"
python -m log_tpu_torch.apps.train --cfg "$CFG" "$@" split val \
    exp "$EXP" ckptname "$CKPT" 2>&1 | grep -aE "scale|psnr|Average|fps" | tail -10

echo "=== demo_interpolate"
python -m log_tpu_torch.apps.train --cfg "$CFG" "$@" split demo_interpolate \
    exp "$EXP" ckptname "$EXP/model_tree_full_wotrain.pth" 2>&1 \
    | grep -aE "Average time|fps|make_video" | tail -5

echo "=== curate output/quality_artifacts"
ART=output/quality_artifacts
mkdir -p "$ART"
# training-time gt|render side-by-sides (first / middle / last)
if ls "$EXP"/vis/*.jpg >/dev/null 2>&1; then
  first=$(ls "$EXP"/vis/*.jpg | head -1)
  last=$(ls "$EXP"/vis/*.jpg | tail -1)
  mid=$(ls "$EXP"/vis/*.jpg | awk '{a[NR]=$0} END{print a[int(NR/2)+1]}')
  cp "$first" "$ART/vis_first_$(basename "$first")"
  cp "$mid" "$ART/vis_mid_$(basename "$mid")"
  cp "$last" "$ART/vis_final_$(basename "$last")"
fi
# val gt|render pairs at each scale
for d in "$EXP"/test/scale_*/; do
  [ -d "$d" ] || continue
  s=$(basename "$d")
  [ -f "$d/gt/0000.png" ] && cp "$d/gt/0000.png" "$ART/val_${s}_gt.png"
  [ -f "$d/renders/0000.png" ] && cp "$d/renders/0000.png" "$ART/val_${s}_render.png"
done
# the demo's video and one frame
demodir=$(ls -d "$EXP"/demo_interpolate* 2>/dev/null | head -1)
if [ -n "${demodir:-}" ]; then
  mp4=$(find "$demodir" -name "*.mp4" | head -1)
  [ -n "$mp4" ] && cp "$mp4" "$ART/demo_interpolate.mp4"
  fr=$(find "$demodir" \( -name "*.jpg" -o -name "*.png" \) | sort | head -1)
  [ -n "$fr" ] && cp "$fr" "$ART/demo_frame_000.${fr##*.}"
fi
# the training run's scalar curve (in its code snapshot)
scal=$(ls "$EXP"/code_backup_*/scalars.jsonl 2>/dev/null | tail -1)
[ -n "$scal" ] && cp "$scal" "$ART/scalars.jsonl"
du -sh "$ART"
ls -la "$ART"
