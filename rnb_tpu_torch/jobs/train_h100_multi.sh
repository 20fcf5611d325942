#!/usr/bin/env bash
# Multi-card training launch (the port's counterpart of
# jobs/train_tpu_pod.sh): torch.distributed.run starts one rank a card on
# this host, the ranks of every host join one process group, and each
# renders its share of the ray batch (rnb_tpu_torch/parallel/: the exact
# global loss, one all-reduce of the gradient a step; NCCL with a card a
# rank). Run this same script on every host, with NODE_RANK set apart:
#
#   NNODES=2 NODE_RANK=0 MASTER_ADDR=host0 MASTER_PORT=29500 \
#     rnb_tpu_torch/jobs/train_h100_multi.sh CASE [CONF] [EXTRA_ARGS...]
#
# Environment: NNODES (1), NODE_RANK (0), NPROC_PER_NODE (this host's card
# count), MASTER_ADDR (localhost), MASTER_PORT (29500), and the conf
# overrides of train_h100.sh (N_ITERATIONS, WARM_UP_ITER, BATCH_SIZE,
# LEARNING_RATE). The batch must divide by the ranks launched.
#
# Memory scaling: add `--set train.view_shard=true` and each rank loads
# from disk ONLY the views it owns (parallel/data.py; checked by
# rnb_tpu_torch/tools/multinode_smoke.py) — the dataset then scales with the
# cards instead of being capped by one.
set -euo pipefail

CASE="${1:?usage: train_h100_multi.sh CASE [CONF] [extra args]}"
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
CONF="${2:-${REPO}/confs/wmask_rnb.conf}"
shift || true; shift || true

export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"

OVERRIDES=()
[ -n "${N_ITERATIONS:-}" ]  && OVERRIDES+=(--set "train.end_iter=${N_ITERATIONS}")
[ -n "${WARM_UP_ITER:-}" ]  && OVERRIDES+=(--set "train.warm_up_iter=${WARM_UP_ITER}")
[ -n "${BATCH_SIZE:-}" ]    && OVERRIDES+=(--set "train.batch_size=${BATCH_SIZE}")
[ -n "${LEARNING_RATE:-}" ] && OVERRIDES+=(--set "train.learning_rate=${LEARNING_RATE}")

NPROC="${NPROC_PER_NODE:-$(python -c 'import torch; print(torch.cuda.device_count())')}"
if [ "${NPROC}" -lt 1 ]; then
  echo "train_h100_multi.sh: no card on this host; set NPROC_PER_NODE" >&2
  exit 1
fi

python -m torch.distributed.run \
    --nnodes "${NNODES:-1}" \
    --node_rank "${NODE_RANK:-0}" \
    --nproc_per_node "${NPROC}" \
    --master_addr "${MASTER_ADDR:-localhost}" \
    --master_port "${MASTER_PORT:-29500}" \
    -m rnb_tpu_torch.cli \
    --mode train_rnb \
    --conf "${CONF}" \
    --case "${CASE}" \
    --shard auto \
    ${OVERRIDES[@]+"${OVERRIDES[@]}"} \
    "$@"
