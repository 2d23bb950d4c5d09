"""Stage 2 in plain PyTorch: batched Gauss-Newton with an analytic Jacobian.

The semantics of FitOrientation (paper §V-C): for each grid point, fit the
ZYZ orientation ``theta`` whose signature matches the observation, by
``iters`` Levenberg-damped Gauss-Newton steps from ``theta0``::

    r = f(theta) - y;  J = df/dtheta;  theta -= solve(J^T J + d I, J^T r)

with f(theta) = [sin(3 u) p, cos(2 v) p] over the rotated g-vectors
(u, v, p) = g R(theta)^T. The Jacobian is written out by hand (the program
differentiates with ``torch.func``), batched over points with no ``vmap``.
Float32 with TF32 off; ``tf32=True`` rounds every product's operands to
TF32's 10-bit mantissa first, the control that a lower precision must fail.
"""
from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to TF32 (10 mantissa bits, nearest-even), kept
    in float32: what a TF32 tensor-core product reads of its operands."""
    bits = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def _rz(t: torch.Tensor, d: bool) -> torch.Tensor:
    c, s = torch.cos(t), torch.sin(t)
    z, o = torch.zeros_like(t), torch.ones_like(t)
    if d:                       # d/dt of [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        return torch.stack([-s, -c, z, c, -s, z, z, z, z], -1)
    return torch.stack([c, -s, z, s, c, z, z, z, o], -1)


def _ry(t: torch.Tensor, d: bool) -> torch.Tensor:
    c, s = torch.cos(t), torch.sin(t)
    z, o = torch.zeros_like(t), torch.ones_like(t)
    if d:                       # d/dt of [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        return torch.stack([-s, z, c, z, z, z, -c, z, -s], -1)
    return torch.stack([c, z, s, z, o, z, -s, z, c], -1)


def rotation(theta: torch.Tensor) -> torch.Tensor:
    """(P, 3) angles -> (P, 3, 3) ZYZ rotations Rz(a) Ry(b) Rz(c)."""
    a, b, c = theta.unbind(-1)
    shape = theta.shape[:-1] + (3, 3)
    return (_rz(a, False).view(shape) @ _ry(b, False).view(shape)
            @ _rz(c, False).view(shape))


def model_and_jacobian(theta: torch.Tensor, gvec: torch.Tensor,
                       tf32: bool = False):
    """(f (P, 2N), J (P, 2N, 3)) at orientations ``theta`` (P, 3)."""
    a, b, c = theta.unbind(-1)
    shape = theta.shape[:-1] + (3, 3)
    A, B, C = (m(t, False).view(shape) for m, t in
               ((_rz, a), (_ry, b), (_rz, c)))
    dA, dB, dC = (m(t, True).view(shape) for m, t in
                  ((_rz, a), (_ry, b), (_rz, c)))
    R = _mm(_mm(A, B, tf32), C, tf32)
    dR = torch.stack([_mm(_mm(dA, B, tf32), C, tf32),
                      _mm(_mm(A, dB, tf32), C, tf32),
                      _mm(_mm(A, B, tf32), dC, tf32)], 1)   # (P, 3, 3, 3)
    rot = _mm(gvec, R.transpose(-1, -2), tf32)              # (P, N, 3)
    drot = _mm(gvec, dR.transpose(-1, -2), tf32)            # (P, 3, N, 3)
    u, v, p = rot.unbind(-1)
    du, dv, dp = drot.unbind(-1)                            # (P, 3, N)
    s3, c3 = torch.sin(3.0 * u), torch.cos(3.0 * u)
    s2, c2 = torch.sin(2.0 * v), torch.cos(2.0 * v)
    f = torch.cat([s3 * p, c2 * p], -1)
    j1 = 3.0 * c3[:, None] * du * p[:, None] + s3[:, None] * dp
    j2 = -2.0 * s2[:, None] * dv * p[:, None] + c2[:, None] * dp
    J = torch.cat([j1, j2], -1).transpose(1, 2)             # (P, 2N, 3)
    return f, J


def gauss_newton(y: torch.Tensor, gvec: torch.Tensor, theta0: torch.Tensor,
                 iters: int = 12, damping: float = 1e-3,
                 tf32: bool = False) -> torch.Tensor:
    """(P, 3) fitted orientations, float32, on ``y``'s device."""
    y, gvec = y.float(), gvec.float().to(y.device)
    theta = theta0.float().to(y.device)
    eye = damping * torch.eye(3, dtype=torch.float32, device=y.device)
    for _ in range(iters):
        f, J = model_and_jacobian(theta, gvec, tf32)
        r = (f - y)[..., None]
        Jt = J.transpose(1, 2)
        step = torch.linalg.solve(_mm(Jt, J, tf32) + eye, _mm(Jt, r, tf32))
        theta = theta - step[..., 0]
    return theta


def fit_blocks(y: torch.Tensor, gvec: torch.Tensor, theta0: torch.Tensor,
               iters: int, damping: float, tf32: bool = False,
               block: int = 50_000) -> torch.Tensor:
    """:func:`gauss_newton` over blocks of ``block`` points, so that the
    reference's Jacobians fit beside whatever else the device holds."""
    out = [gauss_newton(y[i:i + block], gvec, theta0[i:i + block], iters,
                        damping, tf32) for i in range(0, y.shape[0], block)]
    return torch.cat(out)
