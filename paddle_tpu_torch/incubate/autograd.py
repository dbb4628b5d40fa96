"""paddle.incubate.autograd. reference: paddle_tpu/incubate/autograd.py:
the functional transforms under their class-style names, and the
primitive-mode flags.

torch's autograd differentiates aten operators, already primitive, so prim
mode changes nothing here; the switches record the caller's choice, as the
reference's do.
"""

from __future__ import annotations

from ..autograd import hessian, jacobian, jvp, vjp  # noqa: F401

Jacobian = jacobian
Hessian = hessian

__all__ = ["jvp", "vjp", "Jacobian", "Hessian", "enable_prim",
           "disable_prim", "prim_enabled", "prim2orig"]

_prim = [True]


def enable_prim():
    _prim[0] = True


def disable_prim():
    _prim[0] = False


def prim_enabled():
    return _prim[0]


def prim2orig(block=None):
    """The reference's prim2orig pass: there is no separate primitive IR,
    so the block comes back as it is."""
    return block
