#!/usr/bin/env bash
# Actor half of the two-process mode (reference:
# examples/async_sac_state_sim/run_actor.sh). The JAX package's actor forces
# the CPU backend because one process owns a TPU; two processes can share a
# CUDA card, so this actor runs on the card unless ACTOR_DEVICE says
# otherwise (ACTOR_DEVICE=cpu for an actor on a host without one, such as a
# robot's workstation; LEARNER_IP names the learner's host). Extra args go
# to the example, e.g. --port 6000 --max_steps 100000.
set -euo pipefail
cd "$(dirname "$0")/../../.."

exec python3 -m serl_tpu_torch.examples.async_sac_state_sim --actor \
    --device "${ACTOR_DEVICE:-cuda}" \
    --ip "${LEARNER_IP:-127.0.0.1}" \
    --random_steps 1000 \
    --steps_per_update 30 \
    "$@"
