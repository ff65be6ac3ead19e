"""Shared spectral time integrators — port of ``repro.solvers.integrators``.

The state ``y`` is a tuple of tensors (planar ``(re, im)`` pairs, possibly
with a leading component axis), where the reference takes a pytree:

* :func:`rk4` — classic explicit 4th-order Runge–Kutta on ``∂y = rhs(y)``;
* :func:`ifrk4` — integrating-factor RK4 for ``∂y = decay·y + N(y)``, the
  stiff diagonal linear term integrated exactly;
* :func:`exp_decay` — that exact linear propagator alone.

``decay`` is one real tensor broadcastable against every entry of ``y``.
"""

from __future__ import annotations

import torch


def _map(f, *trees):
    return tuple(f(*leaves) for leaves in zip(*trees))


def _axpy(a, x, y):
    """y + a·x, entrywise."""
    return _map(lambda xi, yi: yi + a * xi, x, y)


def rk4(rhs, y, dt):
    """One classic RK4 step of ``∂y = rhs(y)``."""
    k1 = rhs(y)
    k2 = rhs(_axpy(dt / 2, k1, y))
    k3 = rhs(_axpy(dt / 2, k2, y))
    k4 = rhs(_axpy(dt, k3, y))
    return _map(
        lambda yi, a, b, c, d: yi + (dt / 6) * (a + 2 * b + 2 * c + d),
        y, k1, k2, k3, k4)


def exp_decay(decay, y, dt):
    """Exact propagator of ``∂y = decay·y``: y ← e^{decay·dt} y."""
    e = torch.exp(decay * dt)
    return _map(lambda yi: e * yi, y)


def ifrk4(nonlin, decay, y, dt):
    """Integrating-factor RK4 for ``∂y = decay·y + N(y)`` (E = e^{decay·dt/2}):

        k1 = N(y)
        k2 = N(E·(y + dt/2·k1))
        k3 = N(E·y + dt/2·k2)
        k4 = N(E²·y + dt·E·k3)
        y ← E²·y + dt/6·(E²·k1 + 2E·(k2 + k3) + k4)
    """
    e1 = torch.exp(decay * (dt / 2))
    e2 = e1 * e1
    mul = lambda e, t: _map(lambda a: e * a, t)
    k1 = nonlin(y)
    k2 = nonlin(mul(e1, _axpy(dt / 2, k1, y)))
    k3 = nonlin(_axpy(dt / 2, k2, mul(e1, y)))
    k4 = nonlin(_axpy(dt, mul(e1, k3), mul(e2, y)))
    return _map(
        lambda yi, a, b, c, d: e2 * yi + (dt / 6) * (e2 * a + 2 * e1 * (b + c)
                                                     + d),
        y, k1, k2, k3, k4)
