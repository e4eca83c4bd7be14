"""`correct` for the env stage: the program's env steps held to the plain reference.

The probe copies the env's reset and the steps that the set-up and the window
take at the iterations `Probe.env_checked` names (the first, the first with
the policy's actions, the last checked one, and the time limit's auto-reset
and the step after it, where the window reaches them): each step's state,
action and the reset positions drawn in it, and what it returned. The
reference (`reference/pick.py`, the port's plain physics and renderer) takes
the same inputs. It can only follow the program step by step from the
program's state; the reset, which starts the chain, it makes from the reset
positions alone. Compared, each the worst over the copied steps:

  k1_cap            the state after the step against the reference's: the
                    worst error of a field over its cap in the K1 rule
                    (tests/torch_k1.py's STEP_CAP, which no env may pass; the
                    initial height as the cube's position); the step count
                    and episode id exactly (inf where they differ);
  k1_share          the share of envs, over the copied steps, with a field
                    beyond the rule's tight tolerance (STEP_ATOL plus three
                    times float32's distance to float64). The rule lets 1% of
                    many rollout envs pass it, where float32 rounding flips
                    the sign of a small quaternion component; at the reset
                    pose, which sits on that flip, some envs in ten pass it
                    (the kernel's own code built for the CPU does the same).
                    A fault shifts every env.
  obs_gap           the widest gap of the reward (against the reference's
                    step) and of the proprio observation (against the
                    reference's reading of the program's state); a done or
                    success flag that differs reads inf.
  pixel_flip_share  the share of pixels that differ from the reference's
                    render of the program's state by more than one level (the
                    K2 rule of tests/torch_k2.py allows 0.5%);
  pixels_off_edge   such pixels that lie on no edge of the reference's frame
                    and on no border between two of its surfaces, a surface
                    being a primitive or one face of a box (the K2 rule
                    allows none).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark.reference import pick
from benchmark.reference.env import rendering

# tests/torch_k1.py's per-env rule: what two float32 implementations of one
# control step may differ by, per field
STEP_ATOL = {
    "qpos": 5e-5, "qvel": 2e-3, "theta": 5e-6, "dtheta": 1e-3,
    "grip_ctrl": 0.0, "mocap_pos": 0.0, "mocap_quat": 0.0,
    "cube_pos": 1e-6, "cube_quat": 5e-5, "cube_linvel": 2e-4, "cube_angvel": 3e-2,
}
STEP_CAP = {
    "qpos": 2e-3, "qvel": 1e-1, "theta": 2e-5, "dtheta": 2e-3,
    "grip_ctrl": 0.0, "mocap_pos": 0.0, "mocap_quat": 0.0,
    "cube_pos": 2e-5, "cube_quat": 2e-4, "cube_linvel": 2e-3, "cube_angvel": 1e-1,
}
EXACT = ("t", "ep_id")
HEIGHT = "cube_pos"  # the rule's field for the initial height, z_init
EDGE_LEVELS = 8  # tests/torch_k2.py: a 3x3 neighbourhood spanning more is an edge


def _per_env(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.double() - b.double()).abs().reshape(a.shape[0], -1).amax(1)


def k1_errors(got: Dict, want32: Dict, want64: Dict):
    """Per env: the worst error over the cap ((N,), a field capped at 0 that
    differs reads inf), whether any field is beyond the tight tolerance
    ((N,) bool), and the field that set the worst; a differing exact field
    reads inf for every env."""
    n = got["t"].shape[0]
    over_cap = torch.zeros(n, dtype=torch.float64, device=got["t"].device)
    over_tight = torch.zeros(n, dtype=torch.bool, device=got["t"].device)
    field = None
    for f in EXACT:
        if not torch.equal(got[f], want32[f]):
            return torch.full_like(over_cap, float("inf")), ~over_tight, f
    for f in pick.PHYSICS + ("z_init",):
        rule = HEIGHT if f == "z_init" else f
        err = _per_env(got[f], want32[f])
        tight = torch.clamp(STEP_ATOL[rule] + 3.0 * _per_env(want32[f], want64[f]),
                            max=STEP_CAP[rule])
        ratio = torch.where(err == 0, torch.zeros_like(err), err / STEP_CAP[rule])
        ratio = torch.where(torch.isnan(ratio), float("inf"), ratio)
        if field is None or float(ratio.max()) > float(over_cap.max()):
            field = f
        over_cap = torch.maximum(over_cap, ratio)
        over_tight |= ~(err <= tight)
    return over_cap, over_tight, field


def edge_mask(img: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool: pixels whose 3x3 neighbourhood in `img` (N, H, W, 3)
    spans more than EDGE_LEVELS levels in some channel."""
    x = img.to(torch.float32).movedim(-1, -3)
    hi = torch.nn.functional.max_pool2d(x, 3, stride=1, padding=1)
    lo = -torch.nn.functional.max_pool2d(-x, 3, stride=1, padding=1)
    return ((hi - lo) > EDGE_LEVELS).any(1)


def surface_edge_mask(ids: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool: pixels whose 3x3 neighbourhood in `ids` holds more than one surface."""
    x = ids.to(torch.float32)[:, None]
    hi = torch.nn.functional.max_pool2d(x, 3, stride=1, padding=1)
    lo = -torch.nn.functional.max_pool2d(-x, 3, stride=1, padding=1)
    return (hi != lo)[:, 0]


def _hit_distances(scene, rays) -> torch.Tensor:
    big = torch.full_like(rays[3], rendering.BIG)
    zero = torch.zeros_like(rays[3])
    fresh = (big, zero, zero, zero)
    ts = [rendering._render_plane(fresh, rays)[0]]
    ts += [rendering._render_sphere(fresh, rays, scene.sph_c[:, i], scene.sph_r[i],
                                    scene.sph_col[i])[0] for i in range(rendering.N_SPH)]
    ts += [rendering._render_capsule(fresh, rays, scene.cap_a[:, i], scene.cap_b[:, i],
                                     scene.cap_r[i], scene.cap_col[i])[0]
           for i in range(rendering.N_CAP)]
    ts += [rendering._render_box(fresh, rays, scene.box_c[:, i], scene.box_R[:, i],
                                 scene.box_h[i], scene.box_col[i])[0]
           for i in range(rendering.N_BOX)]
    return torch.stack(ts)


def _box_faces(scene, rays) -> torch.Tensor:
    """(boxes, N, P): the face of each box that each ray enters, as the plain
    renderer's slab test picks it for its shading (the axis with the largest
    entry, the first of ties), 2 * axis + (the ray runs along the axis)."""
    ox, oy, oz, dx, dy, dz = rays
    faces = []
    for i in range(rendering.N_BOX):
        c, R, h = scene.box_c[:, i], scene.box_R[:, i], scene.box_h[i]
        wx, wy, wz = ox - c[:, 0:1], oy - c[:, 1:2], oz - c[:, 2:3]
        entries, along = [], []
        for k in range(3):
            r0, r1, r2 = R[:, 0, k:k + 1], R[:, 1, k:k + 1], R[:, 2, k:k + 1]
            ol = r0 * wx + r1 * wy + r2 * wz
            dl = r0 * dx + r1 * dy + r2 * dz
            guard = torch.where(dl >= 0, 1e-9, -1e-9)
            inv = 1.0 / torch.where(dl.abs() < 1e-9, guard, dl)
            entries.append(torch.minimum((-h[k] - ol) * inv, (h[k] - ol) * inv))
            along.append(dl > 0)
        axis = torch.stack(entries).argmax(0)
        faces.append(2 * axis + torch.stack(along).gather(0, axis[None])[0].long())
    return torch.stack(faces)


def surface_ids(phys, size: int):
    """(front, wrist) (N, size, size): the surface each pixel's ray meets
    first in the plain renderer's float32 arithmetic, -1 for the sky: the
    primitive, and for a box the face it enters (8 * primitive + face), as
    two faces of one box are lit apart and may differ by a few levels only,
    the edge of a box face that the K2 rule names beside silhouettes."""
    scene = rendering.build_scene(phys)
    pos, rot = rendering.camera_poses(phys)
    grid = rendering.pixel_grid(size, phys.qpos.device)
    first_box = 1 + rendering.N_SPH + rendering.N_CAP  # the floor, spheres, capsules, boxes
    out = []
    for c in (0, 1):
        rays = rendering.camera_rays(pos[:, c], rot[:, c], grid[c])
        t = _hit_distances(scene, rays)
        prim = t.argmin(0)
        box = (prim - first_box).clamp(0, rendering.N_BOX - 1)
        face = torch.where(prim >= first_box, _box_faces(scene, rays).gather(0, box[None])[0], 0)
        ids = torch.where(t.amin(0) < rendering.BIG, 8 * prim + face, -1)
        out.append(ids.reshape(-1, size, size))
    return tuple(out)


def pixel_counts(got: torch.Tensor, want: torch.Tensor, ids: torch.Tensor):
    """(pixels, pixels beyond one level, of them off every edge)."""
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs().amax(-1)
    beyond = diff > 1
    edges = edge_mask(want) | surface_edge_mask(ids)
    return diff.numel(), int(beyond.sum()), int((beyond & ~edges).sum())


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def numbers(records: List[Dict], image_keys, size: int, device, control: bool = False,
            where: Optional[Dict] = None) -> Dict[str, float]:
    """The env's compared numbers over the copied records. With `control`,
    the reference one step below float32 (bfloat16) stands in the program's
    place."""
    where = {} if where is None else where
    k1_cap, k1_over, k1_envs, obs_gap, pixels, beyond, off = 0.0, 0, 0, 0.0, 0, 0, 0
    f32, f64 = torch.float32, torch.float64
    for rec in records:
        rec = _to(rec, device)
        if rec["kind"] == "reset":
            want32 = pick.fresh(rec["xy"], rec["after"]["ep_id"], f32)
            want64 = pick.fresh(rec["xy"], rec["after"]["ep_id"], f64)
            got, flags = rec["after"], {}
            if control:
                got = pick.fresh(rec["xy"], rec["after"]["ep_id"], torch.bfloat16)
        else:
            _, want32, out32 = pick.step(rec["before"], rec["action"], rec["xy"], f32)
            _, want64, _ = pick.step(rec["before"], rec["action"], rec["xy"], f64)
            got, flags = rec["after"], {k: rec[k] for k in ("reward", "done", "success")}
            if control:
                _, got, out = pick.step(rec["before"], rec["action"], rec["xy"], torch.bfloat16)
                flags = out
            for k in ("done", "success"):
                if not torch.equal(flags[k].float(), out32[k].float()):
                    obs_gap, where["obs_gap"] = float("inf"), [rec["step"], k]
            gap = float((flags["reward"].double() - out32["reward"].double()).abs().max())
            if not gap <= obs_gap:
                obs_gap, where["obs_gap"] = gap, [rec["step"], "reward"]
        over_cap, over_tight, field = k1_errors(got, want32, want64)
        if not float(over_cap.max()) <= k1_cap:
            k1_cap, where["k1_cap"] = float(over_cap.max()), [rec["step"], field]
        k1_over, k1_envs = k1_over + int(over_tight.sum()), k1_envs + over_tight.numel()
        # the observation of the program's state, by the reference
        obs = rec["obs"]
        if control:
            obs = pick.observe(got, size, torch.bfloat16)
        ref = pick.observe(got if control else rec["after"], size, f32)
        gap = float((obs["state"].double() - ref["state"].double()).abs().max())
        if not gap <= obs_gap:
            obs_gap, where["obs_gap"] = gap, [rec["step"], "state"]
        ids = dict(zip(("front", "wrist"),
                       surface_ids(pick.physics(rec["after"] if not control else got, f32), size)))
        for k in image_keys:
            n, b, o = pixel_counts(obs[k], ref[k], ids[k])
            pixels, beyond, off = pixels + n, beyond + b, off + o
    where["k1_share"] = [k1_over, k1_envs]
    return {"k1_cap": k1_cap, "k1_share": k1_over / max(k1_envs, 1), "obs_gap": obs_gap, "pixel_flip_share": beyond / max(pixels, 1),
            "pixels_off_edge": float(off)}
