#!/usr/bin/env bash
# One-card training launch on an H100 (the port's counterpart of
# jobs/train_tpu.sh): rnb_tpu_torch's command line, no JAX.
#
# Usage: rnb_tpu_torch/jobs/train_h100.sh CASE [CONF] [EXTRA_ARGS...]
#
# The per-case hyperparameters of the reference's job files map from the
# environment to conf overrides, as in jobs/train_tpu.sh:
#
#   N_ITERATIONS=1000 BATCH_SIZE=512 LEARNING_RATE=5e-4 WARM_UP_ITER=700 \
#     rnb_tpu_torch/jobs/train_h100.sh bearPNG ./confs/wmask_rnb.conf
#
# Extra arguments pass through to the command line, e.g.
#   ... train_h100.sh bearPNG ./confs/wmask_rnb.conf --set train.save_freq=5000
#   ... train_h100.sh sphere CONF --device cpu     # the CPU, for a check
#
# CONF defaults to the repository's confs/wmask_rnb.conf. The conf's data/
# and exp/ paths are the current directory's, and so is the tee'd log,
# exp/CASE/logs_launch/train_<stamp>.log.
set -euo pipefail

CASE="${1:?usage: train_h100.sh CASE [CONF] [extra args]}"
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
CONF="${2:-${REPO}/confs/wmask_rnb.conf}"
shift || true; shift || true

export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"

OVERRIDES=()
[ -n "${N_ITERATIONS:-}" ]  && OVERRIDES+=(--set "train.end_iter=${N_ITERATIONS}")
[ -n "${WARM_UP_ITER:-}" ]  && OVERRIDES+=(--set "train.warm_up_iter=${WARM_UP_ITER}")
[ -n "${BATCH_SIZE:-}" ]    && OVERRIDES+=(--set "train.batch_size=${BATCH_SIZE}")
[ -n "${LEARNING_RATE:-}" ] && OVERRIDES+=(--set "train.learning_rate=${LEARNING_RATE}")

LOG_DIR="exp/${CASE}/logs_launch"
mkdir -p "${LOG_DIR}"
STAMP="$(date +%Y%m%d_%H%M%S)"

python -m rnb_tpu_torch.cli \
    --mode train_rnb \
    --conf "${CONF}" \
    --case "${CASE}" \
    ${OVERRIDES[@]+"${OVERRIDES[@]}"} \
    "$@" 2>&1 | tee "${LOG_DIR}/train_${STAMP}.log"
