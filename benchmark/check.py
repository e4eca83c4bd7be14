"""`correct`: what the timed path produced, held to the plain reference.

The reference (`reference/drq.py`, with the configuration's own encoder and
precisions from `reference/<config>.py`, found by its name) starts from the
weights the benchmark made and follows the program's first `checked_updates`
calls of `update_high_utd`, on the batches the program's ring handed them and
the draws the benchmark made. It reads the program's outputs only to judge
them. The numbers compared, each against a limit set from sound runs and the
control (PERF.md lists the readings):

  loss_gap     the widest relative gap of a loss over the checked calls'
               updates (each critic minibatch's loss, the actor's and the
               temperature's), the actor's and the temperature's relative
               to the size of the terms they average where that is larger;
  grad_gap     the first gradient of each group as Adam got it (its first
               moment after one step, over 1 - b1), by the worst leaf: the gap
               between the two norms over the reference's norm of that leaf
               or of the group's median leaf, whichever is larger;
  change_gap   the parameters' change over the checked calls, by the worst
               leaf, the same way;
  action_gap   the widest gap of the policy's first sampled actions, taken
               from the reference's parameters after as many calls;
  ring_rows    sampled rows that are not the stored transition with its
               successor (exact: limit 0); with the learner off, the rows
               of the whole ring read back after the window (`readback`).

Leaves whose reference gradient is under a thousandth of the group's median
leaf's (the frozen backbone, whose gradient is zero) are left out of the
gradient and change comparisons. The control puts the reference computed one
step below the configuration's precision in the program's place (its
module's `CONTROL`); a fault mode puts a broken reference there. A traffic
mix with the learner off checks no learning call: its numbers are the
policy's first actions, on the initial weights, the ring's rows and the env's.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

from benchmark import fill as fills
from benchmark import manifest
from benchmark.reference import drq

RULE = 1e-3  # a leaf counts where its reference gradient is at least this share of the median


def spec_of(config: Dict) -> drq.Spec:
    return drq.Spec(
        image_keys=tuple(config["image_keys"]), discount=config["discount"],
        tau=config["soft_target_update_rate"], target_entropy=config["target_entropy"],
        ensemble=config["critic_ensemble_size"], subsample=config["critic_subsample_size"],
        lr=config["learning_rate"], warmup=config["warmup_steps"])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _losses(outs: List[Dict]) -> List[Dict[str, float]]:
    """Each update's losses and, under "scale.<loss>", the size of the
    terms that the actor's and temperature's losses average, which can
    cancel to near zero (a critic loss, a mean of squares, is its own)."""
    out = []
    for o in outs:
        if "critic_loss" in o:
            out.append({"critic.critic_loss": float(o["critic_loss"])})
        else:
            out.append({"actor.actor_loss": float(o["actor_loss"]),
                        "temperature.temperature_loss": float(o["temperature_loss"]),
                        "scale.actor.actor_loss": float(o["scales"]["actor_loss"]),
                        "scale.temperature.temperature_loss": float(o["scales"]["temperature_loss"])})
    return out


def _first_grads(outs: List[Dict]) -> Dict[str, torch.Tensor]:
    """The critic's gradient of the first update, the actor's and the
    temperature's of the first actor update."""
    return {**outs[0]["grads"], **outs[-1]["grads"]}


def _half(batch: Dict, draws: Dict, utd: int):
    """The first half of every minibatch's rows, as the half-batch fault
    takes them."""
    rows = batch["rewards"].shape[0]
    b = rows // utd
    keep = torch.cat([torch.arange(i * b, i * b + b // 2) for i in range(utd)])

    def cut(tree, idx):
        if isinstance(tree, dict):
            return {k: cut(v, idx) for k, v in tree.items()}
        return tree[idx.to(tree.device)]

    half = cut(batch, keep)
    aug = {p: {k: v[keep.to(v.device)] for k, v in by_key.items()} for p, by_key in draws["augment"].items()}
    ups = []
    for d in draws["updates"][:utd]:
        ups.append({k: (v if k == "subsample_idx" else cut(v, torch.arange(b // 2))) for k, v in d.items()})
    ups.append(cut(draws["updates"][utd], keep))
    return half, {"augment": aug, "updates": ups}


def make_learner(config: Dict, params: Dict[str, torch.Tensor], device) -> drq.Learner:
    """The reference learner of the configuration, with its own encoder
    (`reference/<config>.py`), from `params`."""
    encoder = manifest.reference(config["name"]).Encoder(config, device)
    return drq.Learner(spec_of(config), _to(params, device), encoder)


def precision(config: Dict, control: bool = False):
    """The configuration's stated precision, or its control's."""
    ref = manifest.reference(config["name"])
    return ref.CONTROL if control else ref.STATED


def follow(config: Dict, traffic: Dict, initial: Dict[str, torch.Tensor], calls: List[Dict],
           policy: Optional[Dict], device, prec=None, fault: Optional[str] = None):
    """The reference over the checked calls: (losses per update, first grads
    or None where no call is checked, params after, actions of the policy's
    first call or None). `prec` is the configuration's stated precision
    unless given."""
    prec = precision(config) if prec is None else prec
    learner = make_learner(config, initial, device)
    utd = traffic["utd_ratio"]
    losses, grads, actions = [], None, None
    if policy is not None and policy["after_calls"] == 0:
        actions = drq.act(learner, _to(policy["obs"], device), policy["noise"].to(device), prec)
    for i, call in enumerate(calls):
        batch, draws = _to(call["batch"], device), _to(call["draws"], device)
        if fault == "half_batch":
            batch, draws = _half(batch, draws, utd)
        outs = drq.update_high_utd(learner, batch, draws, utd, prec)
        losses += _losses(outs)
        if i == 0:
            grads = {k: v.detach().cpu() for k, v in _first_grads(outs).items()}
        if policy is not None and policy["after_calls"] == i + 1:
            actions = drq.act(learner, _to(policy["obs"], device), policy["noise"].to(device), prec)
    params = {k: v.detach().cpu() for k, v in learner.params.items()}
    return losses, grads, params, None if actions is None else actions.cpu()


def _worst_leaf(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                keep: Dict[str, bool], where: Optional[list] = None) -> float:
    """max over kept leaves of |norm_p - norm_r| / max(norm_r, the group's
    median leaf norm); `where` gets the worst leaf and its two norms."""
    worst = 0.0
    for group in ("actor", "critic", "temperature"):
        names = [k for k in ref if drq.group_of(k) == group and keep.get(k, False)]
        if not names:
            continue
        rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
        med = statistics.median(rn.values())
        for k in names:
            pn = float(torch.linalg.vector_norm(prog[k].double()))
            gap = abs(pn - rn[k]) / max(rn[k], med)
            if not gap <= worst:
                worst = gap
                if where is not None:
                    where[:] = [k, pn, rn[k], med]
    return worst


def kept_leaves(ref_grads: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    keep = {}
    for group in ("actor", "critic", "temperature"):
        names = [k for k in ref_grads if drq.group_of(k) == group]
        norms = {k: float(torch.linalg.vector_norm(ref_grads[k].double())) for k in names}
        med = statistics.median(norms.values()) if norms else 0.0
        keep.update({k: norms[k] >= RULE * med and norms[k] > 0 for k in names})
    return keep


def compare(initial, ref, side, where: Optional[Dict] = None) -> Dict[str, float]:
    """The compared numbers between the reference's (losses, grads, params,
    actions) and another side's; `where` gets what set each. Without a
    checked learning call (no reference gradients) only the actions."""
    where = {} if where is None else where
    r_actions, s_actions = ref[3], side[3]
    out = {} if ref[1] is None else _learning_gaps(initial, ref, side, where)
    if r_actions is not None and s_actions is not None:
        out["action_gap"] = float((s_actions - r_actions).abs().max())
    return out


def _learning_gaps(initial, ref, side, where: Dict) -> Dict[str, float]:
    r_losses, r_grads, r_params, _ = ref
    s_losses, s_grads, s_params, _ = side
    loss_gap = 0.0
    for i, (r, s) in enumerate(zip(r_losses, s_losses, strict=True)):
        for k, v in r.items():
            if k.startswith("scale."):
                continue
            gap = abs(s[k] - v) / max(abs(v), r.get(f"scale.{k}", 0.0), 1e-12)
            if not gap <= loss_gap:
                loss_gap, where["loss_gap"] = gap, [i, k, s[k], v]
    keep = kept_leaves(r_grads)
    init = {k: v.cpu() for k, v in initial.items()}
    where["grad_gap"], where["change_gap"] = [], []
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_leaf(s_grads, r_grads, keep, where["grad_gap"]),
            "change_gap": _worst_leaf({k: s_params[k] - init[k] for k in r_params},
                                      {k: r_params[k] - init[k] for k in r_params}, keep,
                                      where["change_gap"])}


def ring_rows(inserts: List, fill: "fills.Fill", shapes: Dict, calls: List[Dict], image_keys,
              device) -> int:
    """Rows of the checked batches that are not a stored transition (found
    by its action) with its successor in the same stream and episode: the
    loop's inserts as the probe copied them, and the seed-made rows drawn
    again (`fill.py`). No insert wraps the ring before the checked calls."""
    streams = fill.streams
    ep, where = {}, {}  # slot -> (streams,) episode ids; action bytes -> (slot, stream)
    rows: Dict = {}  # (slot, stream) -> the row's leaves
    for slot, t, e in inserts:
        ep[slot] = e
        for s in range(streams):
            where[t["actions"][s].numpy().tobytes()] = (slot, s)
            rows[slot, s] = _row(t, s)
    for c in fills.chunks(fill):
        data = fills.chunk(fill, c, shapes, device)
        lo = fill.first + c * fills.CHUNK
        ids = data["ep_ids"].cpu().view(-1, streams)
        actions = data["actions"].cpu()
        for i in range(ids.shape[0]):
            ep[lo + i] = ids[i]
            for s in range(streams):
                where[actions[i * streams + s].numpy().tobytes()] = (lo + i, s)
    hits = []
    for call in calls:
        b = call["batch"]
        for r in range(b["rewards"].shape[0]):
            hit = where.get(b["actions"][r].numpy().tobytes())
            if hit is not None:
                i, e = hit
                j = i + 1 if i + 1 in ep and ep[i + 1][e] == ep[i][e] else i
                hit = (i, j, e)
            hits.append((b, r, hit))
    wanted: Dict[int, List[int]] = {}
    for _, _, hit in hits:
        if hit is not None:
            for slot in hit[:2]:
                if (slot, hit[2]) not in rows:
                    wanted.setdefault(slot, []).append(hit[2])
    for slot, s, leaves in fills.rows(fill, wanted, shapes, device):
        rows[slot, s] = leaves
    bad = 0
    for b, r, hit in hits:
        if hit is None:
            bad += 1
            continue
        i, j, e = hit
        now, nxt = rows[i, e], rows[j, e]
        same = all(torch.equal(b[k][r], now[k]) for k in ("actions", "rewards", "masks", "dones"))
        same = same and torch.equal(b["observations"]["state"][r], now["observations"]["state"])
        same = same and torch.equal(b["next_observations"]["state"][r], nxt["observations"]["state"])
        for k in image_keys:
            same = same and torch.equal(b["observations"][k][r, -1], now["observations"][k])
            same = same and torch.equal(b["next_observations"][k][r, -1], nxt["observations"][k])
        bad += not same
    return bad


def readback(rb, state, shadow: Dict, seed: int, where: Optional[Dict] = None) -> int:
    """The whole ring read back after the window through its own `sample`
    and held to `shadow`, the transitions that the loop inserted into each
    slot since the window closed (`cell.refill`, which wrote every slot
    again). Each stream's sampleable slots (all but the newest, whose
    observations are read as the successor of the row before it) are read
    once each, in an order drawn from `seed`, one row a stream a block. A
    row is found by its action; it counts as bad where it is no recorded
    transition, differs from it, or its successor is not the next slot's
    observations (its own, across an episode boundary); and every recorded
    row that no block returned, or returned twice, counts too."""
    slots, streams = state.ep_id.shape
    device = state.ep_id.device
    newest = (state.insert_slot - 1) % slots
    actions = shadow["actions"].reshape(slots * streams, -1).cpu().contiguous().numpy()
    keys = actions.view(f"V{actions.shape[1] * actions.itemsize}").reshape(-1)
    found = {k.tobytes(): i for i, k in enumerate(keys)}
    ep = shadow["ep_id"]
    g = torch.Generator(device=device).manual_seed(seed)
    valid = max(state.size - 1, 0)  # the sampler leaves out the newest slot
    order = torch.argsort(torch.rand((valid, streams), generator=g, device=device), dim=0)
    seen = torch.zeros(slots * streams, dtype=torch.int64)
    bad = 0
    for j in range(valid):
        got = rb.sample(state, streams, u=order[j:j + 1])
        rows = got["actions"].cpu().contiguous().numpy()
        at = torch.tensor([found.get(r.tobytes(), -1) for r in rows.view(keys.dtype).reshape(-1)])
        hit = at >= 0
        seen.index_add_(0, at[hit], torch.ones(int(hit.sum()), dtype=torch.int64))
        idx = at.clamp(min=0).to(device)
        slot, stream = idx // streams, idx % streams
        nxt = (slot + 1) % slots
        nxt = torch.where(ep[nxt, stream] == ep[slot, stream], nxt, slot)
        same = hit.to(device)
        for k in ("actions", "rewards", "masks", "dones"):
            same &= _rows_equal(got[k], shadow[k][slot, stream])
        for k, want in shadow["observations"].items():
            now, succ = want[slot, stream], want[nxt, stream]
            got_now, got_next = got["observations"][k], got["next_observations"][k]
            if k != "state":  # the cameras carry the frame stack's axis
                got_now, got_next = got_now[:, -1], got_next[:, -1]
            same &= _rows_equal(got_now, now) & _rows_equal(got_next, succ)
        bad += int((~same).sum())
    expected = torch.ones(slots * streams, dtype=torch.int64)
    expected.view(slots, streams)[newest] = 0
    missed = int((seen != expected).sum())
    if where is not None:
        where["ring_rows"] = [f"{valid * streams} rows read back", f"{bad} bad",
                              f"{missed} missed or twice"]
    return bad + missed


def _rows_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).reshape(a.shape[0], -1).all(1)


def _row(tree, s):
    if isinstance(tree, dict):
        return {k: _row(v, s) for k, v in tree.items()}
    return tree[s]


def draw_z(calls: List[Dict], config: Dict, traffic: Dict, where: Optional[Dict] = None) -> float:
    """The widest departure of the draws that the program made for the
    checked calls from the recipe's distributions, in standard errors of
    the pooled statistic: the crop offsets' mean and variance (uniform whole
    numbers in [0, 2 * pad]), each normal noise's mean and variance, each
    dropout mask's keep share. A draw outside its range, or ensemble subsets
    that over a dozen indices or more take fewer than three members, read
    inf."""
    pad, members = config["crop_padding"], config["critic_ensemble_size"]
    pooled: Dict[str, List[torch.Tensor]] = {}
    for call in calls:
        d = call["draws"]
        for part, by_key in d["augment"].items():
            for k, v in by_key.items():
                pooled.setdefault(f"crop.{part}.{k}", []).append(v)
        for u in d["updates"]:
            for name, v in u.items():
                if name == "subsample_idx":
                    pooled.setdefault("subsample", []).append(v)
                elif name.endswith("_dropout"):
                    for k, m in v.items():
                        pooled.setdefault(f"keep.{name}.{k}", []).append(m)
                else:
                    pooled.setdefault(f"normal.{name}", []).append(v)
    z: Dict[str, float] = {}
    inf = float("inf")
    for name, vs in pooled.items():
        x = torch.cat([v.reshape(-1) for v in vs]).double()
        n = x.numel()
        if name.startswith("crop."):
            if not (bool((x == x.round()).all()) and 0 <= float(x.min()) and float(x.max()) <= 2 * pad):
                z[name] = inf
                continue
            vals = torch.arange(2 * pad + 1, dtype=torch.float64) - pad
            var, m4 = float((vals ** 2).mean()), float((vals ** 4).mean())
            z[f"{name}.mean"] = abs(float(x.mean()) - pad) / (var / n) ** 0.5
            z[f"{name}.var"] = abs(float(x.var()) - var) / ((m4 - var * var) / n) ** 0.5
        elif name.startswith("normal."):
            z[f"{name}.mean"] = abs(float(x.mean())) / (1.0 / n) ** 0.5
            z[f"{name}.var"] = abs(float(x.var()) - 1.0) / (2.0 / n) ** 0.5
        elif name.startswith("keep."):
            z[name] = abs(float(x.mean()) - drq.DROPOUT_KEEP) / (
                drq.DROPOUT_KEEP * (1.0 - drq.DROPOUT_KEEP) / n) ** 0.5
        else:
            in_range = bool((x == x.round()).all()) and 0 <= float(x.min()) and float(x.max()) < members
            z[name] = 0.0 if in_range and (n < 12 or x.unique().numel() >= 3) else inf
    worst = max(z, key=z.get)
    if where is not None:
        where["draw_z"] = [worst, z[worst]]
    return z[worst]
