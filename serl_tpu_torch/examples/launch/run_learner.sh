#!/usr/bin/env bash
# Learner half of the two-process mode (reference:
# examples/async_sac_state_sim/run_learner.sh): the learner trains on the
# CUDA card (LEARNER_DEVICE=cpu for a CPU run) and listens on --port and
# --port + 1. Extra args go to the example.
set -euo pipefail
cd "$(dirname "$0")/../../.."

exec python3 -m serl_tpu_torch.examples.async_sac_state_sim --learner \
    --device "${LEARNER_DEVICE:-cuda}" \
    --batch_size 256 \
    --critic_actor_ratio 8 \
    --training_starts 1000 \
    "$@"
