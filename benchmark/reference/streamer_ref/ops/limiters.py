"""Slope limiters, element-wise on tensors.

Exact port of the reference's ``afivo/src/m_af_limiters.f90``: the Koren
limiter uses the division-free formulation (``:71-97``), van Leer ``:99-113``,
and the generalized minmod family (minmod, MC, gminmod43; ``:115-150``).
All functions take ``a`` (slope from one side) and ``b`` (slope from the
other side) and return the limited slope ``phi(r) * b``-style value.
"""

from __future__ import annotations

import torch

LIMITER_NONE = 1
LIMITER_VANLEER = 2
LIMITER_KOREN = 3
LIMITER_MINMOD = 4
LIMITER_MC = 5
LIMITER_GMINMOD43 = 6
LIMITER_ZERO = 7


def koren(a, b):
    """Modified Koren limiter (af_limiter_koren, ``m_af_limiters.f90:71-97``)."""
    aa = a * a
    ab = a * b
    third = 1.0 / 3.0
    out = torch.where(aa <= 0.25 * ab, 2.0 * a,
                      torch.where(aa <= 2.5 * ab, third * (b + 2.0 * a),
                                  2.0 * b))
    return torch.where(ab <= 0, torch.zeros_like(out), out)


def vanleer(a, b):
    ab = a * b
    pos = ab > 0
    return torch.where(pos, 2.0 * ab / torch.where(pos, a + b,
                                                   torch.ones_like(a)),
                       torch.zeros_like(a))


def gminmod(a, b, theta: float):
    mag = torch.minimum(torch.minimum(torch.abs(theta * a),
                                      torch.abs(theta * b)),
                        0.5 * torch.abs(a + b))
    return torch.where(a * b > 0, torch.sign(a) * mag, torch.zeros_like(a))


def limiter_apply(a, b, limiter: int):
    """Apply a limiter by id (af_limiter_apply)."""
    if limiter == LIMITER_NONE:
        return 0.5 * (a + b)
    if limiter == LIMITER_VANLEER:
        return vanleer(a, b)
    if limiter == LIMITER_KOREN:
        return koren(a, b)
    if limiter == LIMITER_MINMOD:
        return gminmod(a, b, 1.0)
    if limiter == LIMITER_MC:
        return gminmod(a, b, 2.0)
    if limiter == LIMITER_GMINMOD43:
        return gminmod(a, b, 4.0 / 3.0)
    if limiter == LIMITER_ZERO:
        return torch.zeros_like(a)
    raise ValueError(f"unknown limiter {limiter}")
