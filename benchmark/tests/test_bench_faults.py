"""A whole run on the CPU at a tiny size, the harness's look for a card
skipped: sound, it comes out correct; with the timed path broken underneath,
or with the control in the program's place, `correct` comes out false. Each
cell is broken in the ways it can be: a learning cell's step, batch, draws,
actions, sampled rows and env; a collecting cell's (learner off) policy,
ring and env."""

import pytest
import torch

from benchmark.tests.helpers import CELLS, COLLECT_CELLS, LEARN_CELLS, run_tiny


def _failed(result):
    return [k for k, c in result["checks"].items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = run_tiny(workload)
    assert result["correct"], result["checks"]
    assert result["checks"]["ring_rows"]["value"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", COLLECT_CELLS)
def test_learner_off_compares_no_learning_number(workload, monkeypatch):
    """With the learner off nothing is drawn or learned, so those numbers are
    left out, not passed as 0; a limit that no number meets fails the run."""
    from benchmark import run

    result = run_tiny(workload)
    assert set(result["checks"]) == set(run.limits_of(workload))
    assert not {"loss_gap", "grad_gap", "change_gap", "draw_z"} & set(result["checks"])
    assert set(result["not_compared"]) == {"loss_gap", "grad_gap", "change_gap", "draw_z"}
    limits = run.limits_of
    monkeypatch.setattr(run, "limits_of", lambda w: {**limits(w), "draw_z": 7.0})
    assert not run_tiny(workload)["correct"]


def _unchanged_state(monkeypatch):
    """A step that returns its state unchanged: Adam's steps write nothing."""
    from serl_tpu_torch.common import optimizers

    def step(self, params, grads, state):
        return optimizers.OptState(state.count + 1, state.mu, state.nu, state.learning_rate)

    monkeypatch.setattr(optimizers.Optimizer, "step", step)


def _half_batch(monkeypatch):
    """Half of every update's batch left out, the mean taken over the rest."""
    from serl_tpu_torch.agents import sac

    update = sac.SACAgent.update

    def half(self, batch, **kw):
        n = batch["rewards"].shape[0] // 2
        cut = sac._map(lambda v: v[:n], batch)
        draws = kw.get("draws")
        if draws is not None:
            kw["draws"] = {k: (v if k == "subsample_idx" else sac._map(lambda x: x[:n], v))
                           for k, v in draws.items()}
        return update(self, cut, **kw)

    monkeypatch.setattr(sac.SACAgent, "update", half)


def _altered_action(monkeypatch):
    """An answer altered where it is produced: the policy's actions."""
    from serl_tpu_torch.agents import sac

    sample = sac.SACAgent.sample_actions

    def altered(self, *args, **kw):
        return torch.clamp(sample(self, *args, **kw) + 0.05, -1.0, 1.0)

    monkeypatch.setattr(sac.SACAgent, "sample_actions", altered)


def _altered_row(monkeypatch):
    """An answer altered where it is produced: one sampled reward of each batch."""
    from serl_tpu_torch.data import replay_buffer

    sample = replay_buffer.ReplayBuffer.sample

    def altered(self, *args, **kw):
        out = sample(self, *args, **kw)
        out["rewards"] = out["rewards"].clone()
        out["rewards"][0] += 1.0
        return out

    monkeypatch.setattr(replay_buffer.ReplayBuffer, "sample", altered)


def _altered_physics(monkeypatch):
    """An answer altered where it is produced: the env's joint angles after each step."""
    from serl_tpu_torch.envs.physics import engine

    step = engine.control_step

    def altered(state, *args, **kw):
        out = step(state, *args, **kw)
        return out._replace(qpos=out.qpos + 1e-3)

    monkeypatch.setattr(engine, "control_step", altered)


def _altered_frame(monkeypatch):
    """An answer altered where it is produced: a patch of each rendered frame."""
    from serl_tpu_torch.envs import panda_pick

    render = panda_pick.render_cameras

    def altered(*args, **kw):
        frames = tuple(f.clone() for f in render(*args, **kw))
        for f in frames:
            f[:, 4:8, 4:8] = 255 - f[:, 4:8, 4:8]
        return frames

    monkeypatch.setattr(panda_pick, "render_cameras", altered)


def _altered_reward(monkeypatch):
    """An answer altered where it is produced: the env's reward, by 1e-3."""
    from serl_tpu_torch.envs import panda_pick

    step = panda_pick.PandaPickCubeEnv.step_auto_reset

    def altered(self, *args, **kw):
        state, obs, reward, done, info = step(self, *args, **kw)
        return state, obs, reward + 1e-3, done, info

    monkeypatch.setattr(panda_pick.PandaPickCubeEnv, "step_auto_reset", altered)


def _fixed_crop(monkeypatch):
    """The crop's draws fixed: every window at the centre, as if no crop ran."""
    from serl_tpu_torch.agents import drq

    def centred(n, padding, generator, device):
        return torch.full((n, 2), padding, dtype=torch.int64, device=device)

    monkeypatch.setattr(drq, "crop_offsets", centred)


def _wrist_dropped(monkeypatch):
    """The policy acting without its wrist camera (its frames zero)."""
    from serl_tpu_torch.agents import sac

    sample = sac.SACAgent.sample_actions

    def blind(self, observations, **kw):
        return sample(self, {**observations, "wrist": torch.zeros_like(observations["wrist"])}, **kw)

    monkeypatch.setattr(sac.SACAgent, "sample_actions", blind)


def _successor_off_by_one_env(monkeypatch):
    """Each sampled row's successor taken from the next env's stream."""
    from serl_tpu_torch.data import replay_buffer

    sample = replay_buffer.ReplayBuffer.sample

    def shifted(self, *args, **kw):
        out = sample(self, *args, **kw)
        out["next_observations"] = {k: v.roll(1, 0) for k, v in out["next_observations"].items()}
        return out

    monkeypatch.setattr(replay_buffer.ReplayBuffer, "sample", shifted)


def _insert_unchanged(monkeypatch):
    """A ring insert that returns its state unchanged: nothing is written."""
    from serl_tpu_torch.data import replay_buffer

    monkeypatch.setattr(replay_buffer.ReplayBuffer, "insert",
                        lambda self, state, transitions, ep_ids: state)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_action": _altered_action, "altered_row": _altered_row,
          "altered_physics": _altered_physics, "altered_frame": _altered_frame,
          "fixed_crop": _fixed_crop, "altered_reward": _altered_reward,
          "wrist_dropped": _wrist_dropped,
          "successor_off_by_one_env": _successor_off_by_one_env,
          "insert_unchanged": _insert_unchanged}
LEARN_FAULTS = ("altered_action", "altered_frame", "altered_physics", "altered_reward", "altered_row",
                "fixed_crop", "half_batch", "unchanged_state")
COLLECT_FAULTS = ("altered_action", "altered_frame", "altered_physics", "altered_reward",
                  "altered_row", "insert_unchanged", "successor_off_by_one_env", "wrist_dropped")
BROKEN = ([(w, f) for w in LEARN_CELLS for f in LEARN_FAULTS]
          + [(w, f) for w in COLLECT_CELLS for f in COLLECT_FAULTS])


@pytest.mark.parametrize("workload, fault", BROKEN, ids=[f"{w}-{f}" for w, f in BROKEN])
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = run_tiny(workload)
    assert not result["correct"], result["checks"]
    assert _failed(result)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    result = run_tiny(workload, mode="control")
    assert not result["correct"], result["checks"]
