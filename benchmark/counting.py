"""The work of the DrQ learning loop, counted from a configuration's shapes.

A count is a list of `Call`s, each one layer over some rows, with the passes
that the algorithm runs through it: "fwd", "igrad" (the input's gradient,
where the input needs one) and "wgrad" (the weights' gradient, where the
update trains the layer). A convolution, Dense or einsum costs 2 FLOPs per
multiply-add in each pass. A pass that recomputes what another pass of the
same update already computed, on the same parameters and inputs, is counted
once: the frozen backbone's map of each cropped frame (shared by every pass
and the target, whose frozen copy is equal), and in the actor update the
encoder up to its dropout, shared by the policy's and the critic's passes.

`drq_calls` gives one iteration of the loop at a traffic mix: the policy's
forward over every env, and `updates_per_iter` calls of `update_high_utd`,
each `utd_ratio` critic updates of `batch_size` rows, then the actor and
temperature update of the whole batch (none where the mix turns the learner
off). The kernel rooflines read the calls
of their kind (`dense_ln_tanh`: K5's shapes).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

FWD, IGRAD, WGRAD = "fwd", "igrad", "wgrad"
TRAIN_FIRST = (FWD, WGRAD)  # a trained layer whose input needs no gradient
TRAIN = (FWD, IGRAD, WGRAD)


class Call(NamedTuple):
    """`rows` rows through one layer, `count` times, in `passes`. `macs` is
    the layer's multiply-adds per row and member; `shape` is (form, E, K, D)
    for a Dense -> LayerNorm -> tanh (form "linear", "shared" or "member",
    as K5 reads them) and () otherwise."""

    kind: str  # "conv", "dense", "einsum", "dense_ln_tanh"
    rows: int
    macs: int
    passes: Tuple[str, ...]
    members: int = 1
    shape: tuple = ()
    count: int = 1


def flops(call: Call) -> int:
    return 2 * call.rows * call.members * call.macs * len(call.passes) * call.count


def total_flops(calls: Sequence[Call]) -> int:
    return sum(flops(c) for c in calls)


class Encoder(NamedTuple):
    """One camera's encoder. `start`: its layers up to the dropout, as
    (kind, macs per row, trained); `frozen`: the frozen backbone's layers
    (forward only); `bottleneck_in`: the bottleneck's input width;
    `bottleneck_after_dropout`: whether the bottleneck follows the dropout
    (the learned-embedding heads) or belongs to `start` (the small encoder)."""

    start: Tuple[Tuple[str, int, bool], ...]
    frozen: Tuple[int, ...]
    bottleneck_in: int
    bottleneck_dim: int
    bottleneck_after_dropout: bool


def conv_out(size: int, kernel: int, stride: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size // stride)
    return (size - kernel) // stride + 1


def _dlt(rows: int, form: str, e: int, k: int, d: int, passes) -> Call:
    return Call("dense_ln_tanh", rows, k * d, tuple(passes), e, (form, e, k, d))


def _encoder_calls(enc: Encoder, rows: int, n_cams: int, proprio: Tuple[int, int],
                   train: bool, finish_times: int = 1, start: bool = True) -> List[Call]:
    """An encoder pass over `rows` observations: each camera's `start` layers
    (once), its bottleneck `finish_times` times when it follows the dropout,
    and the proprio Dense -> LayerNorm -> tanh (with the start)."""
    calls: List[Call] = []
    if start:
        for i, (kind, macs, trained) in enumerate(enc.start):
            passes = (FWD,)
            if train and trained:
                passes = TRAIN if i > 0 and enc.start[i - 1][2] else TRAIN_FIRST
            calls.append(Call(kind, rows, macs, passes, count=n_cams))
        calls.append(_dlt(rows, "linear", 1, proprio[0], proprio[1],
                          TRAIN_FIRST if train else (FWD,)))
    bottleneck_passes = TRAIN if train else (FWD,)
    if enc.bottleneck_after_dropout:
        calls.append(Call("dense_ln_tanh", rows, enc.bottleneck_in * enc.bottleneck_dim,
                          bottleneck_passes, 1, ("linear", 1, enc.bottleneck_in, enc.bottleneck_dim),
                          count=n_cams * finish_times))
    elif start:
        calls.append(Call("dense_ln_tanh", rows, enc.bottleneck_in * enc.bottleneck_dim,
                          bottleneck_passes, 1, ("linear", 1, enc.bottleneck_in, enc.bottleneck_dim),
                          count=n_cams))
    return calls


def _policy_calls(rows: int, feat: int, hidden: Sequence[int], action_dim: int,
                  train: bool) -> List[Call]:
    calls = []
    k = feat
    for i, d in enumerate(hidden):
        passes = (FWD,) if not train else (TRAIN_FIRST if i == 0 else TRAIN)
        calls.append(_dlt(rows, "linear", 1, k, d, passes))
        k = d
    heads = TRAIN if train else (FWD,)
    calls.append(Call("dense", rows, k * action_dim, heads, count=2))  # mean and std heads
    return calls


def _critic_calls(rows: int, in_dim: int, hidden: Sequence[int], ensemble: int,
                  passes) -> List[Call]:
    calls = []
    k = in_dim
    for i, d in enumerate(hidden):
        calls.append(_dlt(rows, "shared" if i == 0 else "member", ensemble, k, d, passes))
        k = d
    calls.append(Call("dense", rows, k, tuple(passes), ensemble))  # the (E, k, 1) head
    return calls


def drq_calls(config: Dict, traffic: Dict, encoder: Encoder) -> Dict[str, List[Call]]:
    """{"policy": the policy's forward over every env, "update": one
    `update_high_utd`, "iteration": both as one loop iteration runs them}."""
    n_cams = len(config["image_keys"])
    proprio = (config["proprio_dim"], config["proprio_latent_dim"])
    hidden = config["hidden_dims"]
    act = config["action_dim"]
    ens = config["critic_ensemble_size"]
    feat = n_cams * encoder.bottleneck_dim + proprio[1]
    b, utd = traffic["batch_size"], traffic["utd_ratio"]
    rows = b * utd
    frozen_macs = sum(encoder.frozen)

    def frozen(r):
        return [Call("conv", r, frozen_macs, (FWD,), count=n_cams)] if frozen_macs else []

    update: List[Call] = []
    update += frozen(rows) + frozen(rows)  # the maps of the cropped obs and next_obs
    for _ in range(utd):
        # the next actions: the online encoder and the policy on next_obs
        update += _encoder_calls(encoder, b, n_cams, proprio, train=False)
        update += _policy_calls(b, feat, hidden, act, train=False)
        # the target critic on next_obs
        update += _encoder_calls(encoder, b, n_cams, proprio, train=False)
        update += _critic_calls(b, feat + act, hidden, ens, (FWD,))
        # the critic's loss on obs, which trains the encoder
        update += _encoder_calls(encoder, b, n_cams, proprio, train=True)
        update += _critic_calls(b, feat + act, hidden, ens, TRAIN)
    # the actor: the encoder's start once, its bottleneck for each dropout
    update += _encoder_calls(encoder, rows, n_cams, proprio, train=False, finish_times=2)
    update += _policy_calls(rows, feat, hidden, act, train=True)
    update += _critic_calls(rows, feat + act, hidden, ens, (FWD, IGRAD))
    # the temperature: the policy's entropy on next_obs
    update += _encoder_calls(encoder, rows, n_cams, proprio, train=False)
    update += _policy_calls(rows, feat, hidden, act, train=False)

    n = traffic["num_envs"]
    policy = frozen(n) + _encoder_calls(encoder, n, n_cams, proprio, train=False)
    policy += _policy_calls(n, feat, hidden, act, train=False)
    calls = traffic["updates_per_iter"] if traffic.get("learner", True) else 0
    iteration = policy + [c._replace(count=c.count * calls) for c in update if calls]
    return {"policy": policy, "update": update, "iteration": iteration}
