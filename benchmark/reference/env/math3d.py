# A frozen copy of serl_tpu_torch/envs/physics/math3d.py at commit 89bf89d,
# its CUDA binding left out: the benchmark's plain reference of the env.
"""Quaternion / rotation / spatial-algebra helpers on batched fp32 tensors.

Port of `serl_tpu/envs/physics/math3d.py`. Conventions are the same:
quaternions are (w, x, y, z) like MuJoCo, and spatial (6D) vectors are
[angular; linear] expressed at the world origin (Plücker coordinates). Every
function works on any leading batch shape.

The JAX package wraps its physics in `f32_precision` because TPU matmuls
default to bf16 inputs. Here the same guard is "fp32, TF32 off":
`f32_precision` turns TF32 off for cuBLAS/cuDNN while the wrapped function
runs.
"""

import functools

import numpy as np
import torch


def quat_to_mat_np(q) -> np.ndarray:
    """Host-side (numpy) quat->rotation for module-level constants."""
    w, x, y, z = np.asarray(q, np.float32)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return np.asarray(
        [
            [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
            [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
            [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
        ],
        np.float32,
    )


def f32_precision(fn):
    """Run `fn` with TF32 off, so its float32 products stay float32."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn

    return wrapper


def cross(a, b):
    """Cross product over the last axis, broadcasting the leading ones."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def norm(v, keepdim=False):
    return torch.sqrt((v * v).sum(-1, keepdim=keepdim))


def quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_normalize(q, eps=1e-12):
    return q / torch.clamp(norm(q, keepdim=True), min=eps)


def quat_to_mat(q):
    """(…,4) -> (…,3,3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def mat_to_quat(m):
    """(…,3,3) -> (…,4); branchless Shepperd via the 4-candidate trick."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) / 2.0  # |w|, |x|, |y|, |z|
    w, x, y, z = qw.unbind(-1)
    x = torch.copysign(x, m21 - m12)
    y = torch.copysign(y, m02 - m20)
    z = torch.copysign(z, m10 - m01)
    return quat_normalize(torch.stack([w, x, y, z], -1))


def quat_rotate(q, v):
    """Rotate vectors v (…,3) by quaternions q (…,4)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_from_axis_angle(axis, angle):
    half = angle * 0.5
    return torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], dim=-1)


def quat_to_axis_angle(q):
    """Log map: (…,4) -> (…,3) axis*angle, with the small-angle limit."""
    q = torch.where(q[..., :1] < 0, -q, q)  # shortest arc
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    sin_half = norm(v)
    angle = 2.0 * torch.atan2(sin_half, w)
    scale = torch.where(
        sin_half < 1e-8, torch.full_like(sin_half, 2.0),
        angle / torch.clamp(sin_half, min=1e-12),
    )
    return v * scale[..., None]


def quat_integrate(q, omega, dt):
    """Integrate world-frame angular velocity: q' = exp(dt/2 * omega) * q."""
    angle = norm(omega, keepdim=True)
    axis = omega / torch.clamp(angle, min=1e-12)
    dq = quat_from_axis_angle(axis, (angle * dt)[..., 0])
    return quat_normalize(quat_mul(dq, q))


def skew(v):
    """(…,3) -> (…,3,3) cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


# ---------------- spatial (6D) algebra at the world origin ---------------- #


def crm(v):
    """Motion cross-product matrix of spatial velocity v=[w; vo]: (…,6,6)."""
    w, vo = v[..., :3], v[..., 3:]
    Sw, Sv = skew(w), skew(vo)
    zero = torch.zeros_like(Sw)
    top = torch.cat([Sw, zero], dim=-1)
    bot = torch.cat([Sv, Sw], dim=-1)
    return torch.cat([top, bot], dim=-2)


def crf(v):
    """Force cross-product: crf(v) = -crm(v)^T."""
    return -crm(v).transpose(-1, -2)


def spatial_inertia(mass, com, inertia_com):
    """Spatial inertia about the world origin, [w; vo] convention.

    mass: (…,), com: (…,3) world, inertia_com: (…,3,3) world-frame about com.
    I_O = [[I_c + m S S^T, m S], [m S^T, m E]] with S = skew(com).
    """
    S = skew(com)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=S.dtype, device=S.device).expand(S.shape)
    St = S.transpose(-1, -2)
    top = torch.cat([inertia_com + m * (S @ St), m * S], dim=-1)
    bot = torch.cat([m * St, m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)
