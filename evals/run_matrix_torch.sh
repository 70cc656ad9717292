#!/bin/sh
# The port's quality matrix: domains A/B/C/BC x seeds 101/202 through the
# whole pipeline of pyannote_video_tpu_torch (one CUDA card), one JSON line
# per run in $1 (default evals/DOMAINS_torch.jsonl).  The card's name and
# power limit go to standard error first.  Run from the repository root:
#   sh evals/run_matrix_torch.sh [out.jsonl]
set -e
OUT=${1:-evals/DOMAINS_torch.jsonl}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader >&2
: > "$OUT"
for domain in A B C BC; do
  for seed in 101 202; do
    python3 -m pyannote_video_tpu_torch.evals.eval_synthetic "$seed" \
      --domain="$domain" >> "$OUT"
    echo "done: $domain seed $seed" >&2
  done
done
