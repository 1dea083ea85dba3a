#!/bin/bash
# Training-strength runs of family_strength.py side by side on one card:
# the GAIL expert file first (256 maximin-2 games, seed 0, JAX's job 12
# recipe; kept at runs/expert_maximin2_256.npz), then one background
# process a family given as an argument, each logging to
# $STRENGTH_LOG_DIR/<family>.log (default runs/strength); at the end the
# JSON rows of each.
#
#   bash gymothelloenv_tpu_torch/scripts/strength_runs.sh gail gail_only \
#       simple_ppo
set -u
log_dir="${STRENGTH_LOG_DIR:-runs/strength}"
mkdir -p "$log_dir" runs
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
if [ ! -f runs/expert_maximin2_256.npz ]; then
  python -m gymothelloenv_tpu_torch.scripts.make_expert_dataset --games 256 \
    --search-depth 2 --seed 0 --out runs/expert_maximin2_256.npz \
    > "$log_dir/expert.log" 2>&1
  tail -2 "$log_dir/expert.log"
fi
pids=()
for fam in "$@"; do
  python -m gymothelloenv_tpu_torch.scripts.family_strength --family "$fam" \
    > "$log_dir/$fam.log" 2>&1 &
  pids+=($!)
done
rc=0
for p in "${pids[@]}"; do wait "$p" || rc=1; done
for fam in "$@"; do
  echo "== $fam"
  grep -E '^\{|expert rows' "$log_dir/$fam.log"
done
exit $rc
