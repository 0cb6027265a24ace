"""SO(3) / SE(3) exponential and logarithm maps and quaternion operations
(counterpart of matchnerf_tpu/lie.py).

The reference's `Lie` and `Quaternion` classes (misc/camera.py:62-196):
no entry of the port calls them; they are the geometry library's pose
tools (BARF-style pose refinement). The Taylor series (10 terms) keep the
maps smooth and differentiable near theta = 0. Every function takes the
JAX function's shapes: w [..., 3], wu [..., 6], R [..., 3, 3], Rt
[..., 3, 4], q [..., 4] (real part first).
"""
from __future__ import annotations

import math

import torch


def skew_symmetric(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> the cross-product matrix [..., 3, 3]."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    O = torch.zeros_like(w0)
    return torch.stack([torch.stack([O, -w2, w1], dim=-1),
                        torch.stack([w2, O, -w0], dim=-1),
                        torch.stack([-w1, w0, O], dim=-1)], dim=-2)


def _taylor_A(x, nth: int = 10):
    """sin(x) / x."""
    ans = torch.zeros_like(x)
    denom = 1.0
    for i in range(nth + 1):
        if i > 0:
            denom *= (2 * i) * (2 * i + 1)
        ans = ans + (-1) ** i * x ** (2 * i) / denom
    return ans


def _taylor_B(x, nth: int = 10):
    """(1 - cos(x)) / x^2."""
    ans = torch.zeros_like(x)
    denom = 1.0
    for i in range(nth + 1):
        denom *= (2 * i + 1) * (2 * i + 2)
        ans = ans + (-1) ** i * x ** (2 * i) / denom
    return ans


def _taylor_C(x, nth: int = 10):
    """(x - sin(x)) / x^3."""
    ans = torch.zeros_like(x)
    denom = 1.0
    for i in range(nth + 1):
        denom *= (2 * i + 2) * (2 * i + 3)
        ans = ans + (-1) ** i * x ** (2 * i) / denom
    return ans


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_to_SO3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] -> rotation [..., 3, 3]."""
    wx = skew_symmetric(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    return _eye(w) + _taylor_A(theta) * wx + _taylor_B(theta) * (wx @ wx)


def SO3_to_so3(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rotation [..., 3, 3] -> axis-angle [..., 3]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.remainder(
        torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))[..., None, None],
        math.pi)
    lnR = 1 / (2 * _taylor_A(theta) + 1e-8) * (R - R.transpose(-2, -1))
    return torch.stack([lnR[..., 2, 1], lnR[..., 0, 2], lnR[..., 1, 0]], dim=-1)


def se3_to_SE3(wu: torch.Tensor) -> torch.Tensor:
    """[..., 6] (rotation w, translation u) -> [R | V u] [..., 3, 4]."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew_symmetric(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    I = _eye(wu)
    R = I + _taylor_A(theta) * wx + _taylor_B(theta) * (wx @ wx)
    V = I + _taylor_B(theta) * wx + _taylor_C(theta) * (wx @ wx)
    return torch.cat([R, V @ u[..., None]], dim=-1)


def SE3_to_se3(Rt: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """[..., 3, 4] -> [..., 6], the inverse of `se3_to_SE3`."""
    R, t = Rt[..., :3], Rt[..., 3:]
    w = SO3_to_so3(R)
    wx = skew_symmetric(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    A, B = _taylor_A(theta), _taylor_B(theta)
    invV = _eye(Rt) - 0.5 * wx + (1 - A / (2 * B)) / (theta ** 2 + eps) * (wx @ wx)
    u = (invV @ t)[..., 0]
    return torch.cat([w, u], dim=-1)


def q_to_R(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] -> rotation [..., 3, 3]."""
    qa, qb, qc, qd = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (qc ** 2 + qd ** 2), 2 * (qb * qc - qa * qd),
                     2 * (qa * qc + qb * qd)], dim=-1),
        torch.stack([2 * (qb * qc + qa * qd), 1 - 2 * (qb ** 2 + qd ** 2),
                     2 * (qc * qd - qa * qb)], dim=-1),
        torch.stack([2 * (qb * qd - qa * qc), 2 * (qa * qb + qc * qd),
                     1 - 2 * (qb ** 2 + qc ** 2)], dim=-1)], dim=-2)


def R_to_q(R: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rotation [..., 3, 3] -> quaternion [..., 4]."""
    t = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    r = torch.sqrt(1 + t + eps)
    qa = 0.5 * r
    qb = torch.sign(R[..., 2, 1] - R[..., 1, 2]) * 0.5 * torch.sqrt(
        1 + R[..., 0, 0] - R[..., 1, 1] - R[..., 2, 2] + eps)
    qc = torch.sign(R[..., 0, 2] - R[..., 2, 0]) * 0.5 * torch.sqrt(
        1 - R[..., 0, 0] + R[..., 1, 1] - R[..., 2, 2] + eps)
    qd = torch.sign(R[..., 1, 0] - R[..., 0, 1]) * 0.5 * torch.sqrt(
        1 - R[..., 0, 0] - R[..., 1, 1] + R[..., 2, 2] + eps)
    return torch.stack([qa, qb, qc, qd], dim=-1)


def q_invert(q: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(q, dim=-1, keepdim=True)
    conj = torch.cat([q[..., :1], -q[..., 1:]], dim=-1)
    return conj / norm ** 2


def q_product(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    a1, b1, c1, d1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    a2, b2, c2, d2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
                        a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
                        a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
                        a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2], dim=-1)
