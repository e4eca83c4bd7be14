#!/usr/bin/env bash
# Launch the actor/learner pair in a two-pane tmux session (reference:
# examples/async_sac_state_sim/tmux_launch.sh). Extra args go to BOTH
# processes (e.g. --port 6000 --max_steps 100000); ACTOR_DEVICE,
# LEARNER_DEVICE and LEARNER_IP pass through to run_actor.sh and
# run_learner.sh.
#
#   ./tmux_launch.sh            # start
#   tmux attach -t serl_tpu_torch
#   tmux kill-session -t serl_tpu_torch
set -euo pipefail
HERE="$(cd "$(dirname "$0")" && pwd)"
SESSION="${SESSION:-serl_tpu_torch}"

tmux kill-session -t "$SESSION" 2>/dev/null || true
tmux new-session -d -s "$SESSION" -n run "bash $HERE/run_learner.sh $*"
tmux split-window -t "$SESSION":run -v "sleep 2 && bash $HERE/run_actor.sh $*"
echo "started tmux session '$SESSION' (learner top, actor bottom)"
