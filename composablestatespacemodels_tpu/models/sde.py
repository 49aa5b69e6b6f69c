"""Continuous-time latent processes (SDEs).

The three reference SDE families (Sde.scala:69-163) with exact Gaussian
transition kernels plus a generic Euler-Maruyama fallback (Sde.scala:36-43),
and blockwise composition (the reference ``Semigroup[Sde]``,
Sde.scala:204-240).

Design notes:

* the latent state is a flat ``[..., dim]`` array; composition is *static*
  metadata (each component owns a contiguous slice), so composed transitions
  JIT-compile to fixed-shape fused elementwise kernels -- no runtime trees;
* every kernel broadcasts over arbitrary leading axes: particles, chains and
  Monte-Carlo repetitions are added with plain array batching (or ``vmap``),
  never Python loops;
* randomness is counter-based ``jax.random``; a single key draws the whole
  ``[N, dim]`` innovation tensor in one call;
* ``dt`` may be a traced scalar (irregular observation grids stay inside
  ``jit``/``scan``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from . import bijectors
from .params import (BrownianParams, GenBrownianParams, OuParams, param_repeat)


def _bcast_dt(dt):
    """Reshape dt so it broadcasts against ``[..., dim]`` states."""
    dt = jnp.asarray(dt)
    if dt.ndim > 0:
        dt = dt[..., None]
    return dt


class Sde:
    """Base class: static spec (dimension + family) with pure kernels.

    Subclasses implement ``initial_state``, exact ``step`` where available,
    ``drift``/``diffusion`` for the Euler-Maruyama fallback, and
    ``constrain`` mapping unconstrained stored parameters to natural scale
    recycled to ``dim`` entries (reference: Sde.scala:70-73, 99-102, 133-137).
    """

    dim: int

    # -- to be provided by subclasses ----------------------------------------

    def constrain(self, p):
        raise NotImplementedError

    def initial_state(self, p, key, shape: Tuple[int, ...] = ()):
        raise NotImplementedError

    def drift(self, p, x):
        raise NotImplementedError

    def diffusion(self, p, x):
        raise NotImplementedError

    def step(self, p, key, x, dt):
        """Exact transition where known; default Euler-Maruyama.

        Reference: Sde.scala:23-25 (``stepFunction`` defaults to
        ``stepEulerMaruyama``).
        """
        return self.step_euler_maruyama(p, key, x, dt)

    # -- generic machinery -----------------------------------------------------

    def step_euler_maruyama(self, p, key, x, dt):
        """x + a(x) dt + b(x) dW,   dW ~ N(0, dt I).

        Reference: Sde.scala:36-43.
        """
        dtb = _bcast_dt(dt)
        z = jax.random.normal(key, jnp.shape(x), jnp.result_type(x))
        return x + self.drift(p, x) * dtb + self.diffusion(p, x) * jnp.sqrt(dtb) * z

    # -- transposed [dim, N] layout (particle axis last) ----------------------

    def step_t(self, p, key, x_t, dt):
        """Exact transition on a transposed ``[dim, N]`` particle block.

        The particle axis is the minor (last) axis, so a filter scan in
        this layout needs no per-step relayouts.
        """
        raise NotImplementedError(
            f"{type(self).__name__} has no transposed step")

    def initial_state_t(self, p, key, n: int):
        """Transposed initial particle block ``[dim, n]``."""
        m0, c0 = self.initial_moments(p)
        z = jax.random.normal(key, (self.dim, n), m0.dtype)
        return m0[:, None] + jnp.sqrt(c0)[:, None] * z

    def validate(self, p) -> None:
        """Construction-time parameter/shape validation (replaces the
        reference's ReaderT[Try] fail-fast construction, Sde.scala:181-202)."""
        if not isinstance(p, self.param_type):
            raise TypeError(
                f"{type(self).__name__} expects {self.param_type.__name__}, "
                f"got {type(p).__name__}")

    def transition_coeffs(self, p, dt):
        """Exact linear-Gaussian transition x' = a*x + b + N(0, diag(q)).

        Returns ``(a [dim], b [dim], q [dim])``.  All reference SDE families
        have diagonal Gaussian transitions, which makes the exact Kalman
        filter available as a correctness oracle for the particle filter.
        Raises for SDEs without an exact Gaussian transition.
        """
        raise NotImplementedError(
            f"{type(self).__name__} has no exact linear-Gaussian transition")

    def initial_moments(self, p):
        """Mean and (diagonal) variance of the initial state, ``(m0, c0)``."""
        raise NotImplementedError

    # -- simulation -------------------------------------------------------------

    def simulate(self, p, key, t0: float, dt, n_steps: int, x0=None):
        """Simulate a regular-grid path via ``lax.scan``.

        Returns ``(ts [n+1], xs [n+1, dim])`` including the initial state.
        Reference: Sde.scala:45-66 (``simProcess``/``simInit``).
        """
        k0, kscan = jax.random.split(key)
        if x0 is None:
            x0 = self.initial_state(p, k0)

        def body(x, k):
            x1 = self.step(p, k, x, dt)
            return x1, x1

        keys = jax.random.split(kscan, n_steps)
        _, xs = jax.lax.scan(body, x0, keys)
        ts = t0 + dt * jnp.arange(n_steps + 1)
        return ts, jnp.concatenate([x0[None], xs], axis=0)


@dataclasses.dataclass(frozen=True)
class Brownian(Sde):
    """Brownian motion: exact transition x' ~ N(x, sigma*dt).

    ``sigma`` is the *variance* rate per unit time (the reference draws with
    std ``sqrt(sigma*dt)``, Sde.scala:114-123).  Initial state N(m0, diag(c0)).
    """

    dim: int
    param_type = BrownianParams

    def constrain(self, p: BrownianParams):
        return (
            param_repeat(p.m0, self.dim),
            jnp.exp(param_repeat(p.c0, self.dim)),
            jnp.exp(param_repeat(p.sigma, self.dim)),
        )

    def initial_state(self, p, key, shape=()):
        m0, c0, _ = self.constrain(p)
        z = jax.random.normal(key, tuple(shape) + (self.dim,), m0.dtype)
        return m0 + jnp.sqrt(c0) * z

    def step(self, p, key, x, dt):
        _, _, sigma = self.constrain(p)
        dtb = _bcast_dt(dt)
        z = jax.random.normal(key, jnp.shape(x), jnp.result_type(x))
        return x + jnp.sqrt(sigma * dtb) * z

    def step_t(self, p, key, x_t, dt):
        _, _, sigma = self.constrain(p)
        z = jax.random.normal(key, jnp.shape(x_t), jnp.result_type(x_t))
        return x_t + jnp.sqrt(sigma * dt)[:, None] * z

    def transition_coeffs(self, p, dt):
        m0, c0, sigma = self.constrain(p)
        ones = jnp.ones_like(m0)
        return ones, jnp.zeros_like(m0), sigma * dt

    def initial_moments(self, p):
        m0, c0, _ = self.constrain(p)
        return m0, c0

    def drift(self, p, x):
        # Deviation from reference: Sde.scala:110 returns a constant drift of
        # 1.0 (unused dead code -- the exact step overrides EM).  Brownian
        # motion has zero drift.
        return jnp.zeros_like(x)

    def diffusion(self, p, x):
        # sqrt of the variance rate, so Euler-Maruyama matches the exact
        # transition for any dt (the reference's diag(sigma) is inconsistent
        # with its own exact kernel; also dead code).
        _, _, sigma = self.constrain(p)
        return jnp.broadcast_to(jnp.sqrt(sigma), jnp.shape(x))


@dataclasses.dataclass(frozen=True)
class GenBrownian(Sde):
    """Brownian motion with constant drift: x' ~ N(x + mu*dt, sigma*dt).

    Reference: Sde.scala:69-95 (``GenBrownianMotion``).
    """

    dim: int
    param_type = GenBrownianParams

    def constrain(self, p: GenBrownianParams):
        return (
            param_repeat(p.m0, self.dim),
            jnp.exp(param_repeat(p.c0, self.dim)),
            param_repeat(p.mu, self.dim),
            jnp.exp(param_repeat(p.sigma, self.dim)),
        )

    def initial_state(self, p, key, shape=()):
        m0, c0, _, _ = self.constrain(p)
        z = jax.random.normal(key, tuple(shape) + (self.dim,), m0.dtype)
        return m0 + jnp.sqrt(c0) * z

    def step(self, p, key, x, dt):
        _, _, mu, sigma = self.constrain(p)
        dtb = _bcast_dt(dt)
        z = jax.random.normal(key, jnp.shape(x), jnp.result_type(x))
        return x + mu * dtb + jnp.sqrt(sigma * dtb) * z

    def step_t(self, p, key, x_t, dt):
        _, _, mu, sigma = self.constrain(p)
        z = jax.random.normal(key, jnp.shape(x_t), jnp.result_type(x_t))
        return x_t + (mu * dt)[:, None] + jnp.sqrt(sigma * dt)[:, None] * z

    def transition_coeffs(self, p, dt):
        m0, c0, mu, sigma = self.constrain(p)
        ones = jnp.ones_like(m0)
        return ones, mu * dt, sigma * dt

    def initial_moments(self, p):
        m0, c0, _, _ = self.constrain(p)
        return m0, c0

    def drift(self, p, x):
        _, _, mu, _ = self.constrain(p)
        return jnp.broadcast_to(mu, jnp.shape(x))

    def diffusion(self, p, x):
        _, _, _, sigma = self.constrain(p)
        return jnp.broadcast_to(jnp.sqrt(sigma), jnp.shape(x))


@dataclasses.dataclass(frozen=True)
class Ou(Sde):
    """Ornstein-Uhlenbeck with exact mean-reverting Gaussian transition.

    mean = mu + (x - mu) * exp(-phi*dt)
    var  = sigma^2 / (2 phi) * (1 - exp(-2 phi dt))

    Reference: Sde.scala:129-163 (``OuProcess``).  Here ``sigma`` is the
    diffusion coefficient (std rate), matching the reference variance formula.
    """

    dim: int
    param_type = OuParams

    def constrain(self, p: OuParams):
        return (
            param_repeat(p.m0, self.dim),
            jnp.exp(param_repeat(p.c0, self.dim)),
            bijectors.logistic(param_repeat(p.phi, self.dim)),
            param_repeat(p.mu, self.dim),
            jnp.exp(param_repeat(p.sigma, self.dim)),
        )

    def initial_state(self, p, key, shape=()):
        m0, c0, _, _, _ = self.constrain(p)
        z = jax.random.normal(key, tuple(shape) + (self.dim,), m0.dtype)
        return m0 + jnp.sqrt(c0) * z

    def variance(self, p, dt):
        _, _, phi, _, sigma = self.constrain(p)
        dtb = _bcast_dt(dt)
        return (sigma * sigma) / (2.0 * phi) * (1.0 - jnp.exp(-2.0 * phi * dtb))

    def step(self, p, key, x, dt):
        _, _, phi, mu, _ = self.constrain(p)
        dtb = _bcast_dt(dt)
        mean = mu + (x - mu) * jnp.exp(-phi * dtb)
        z = jax.random.normal(key, jnp.shape(x), jnp.result_type(x))
        return mean + jnp.sqrt(self.variance(p, dt)) * z

    def step_t(self, p, key, x_t, dt):
        _, _, phi, mu, _ = self.constrain(p)
        muc = mu[:, None]
        mean = muc + (x_t - muc) * jnp.exp(-phi * dt)[:, None]
        z = jax.random.normal(key, jnp.shape(x_t), jnp.result_type(x_t))
        return mean + jnp.sqrt(self.variance(p, dt))[:, None] * z

    def transition_coeffs(self, p, dt):
        _, _, phi, mu, sigma = self.constrain(p)
        a = jnp.exp(-phi * dt)
        b = mu * (1.0 - a)
        q = (sigma * sigma) / (2.0 * phi) * (1.0 - jnp.exp(-2.0 * phi * dt))
        return a, b, q

    def initial_moments(self, p):
        m0, c0, _, _, _ = self.constrain(p)
        return m0, c0

    def drift(self, p, x):
        _, _, phi, mu, _ = self.constrain(p)
        return phi * (mu - x)

    def diffusion(self, p, x):
        _, _, _, _, sigma = self.constrain(p)
        return jnp.broadcast_to(sigma, jnp.shape(x))


@dataclasses.dataclass(frozen=True)
class CompositeSde(Sde):
    """Blockwise (block-diagonal) composition of independent SDEs.

    The composed latent state is the concatenation of component states; each
    component advances its own slice.  This is the reference ``Semigroup[Sde]``
    (Sde.scala:204-240) with the runtime tree replaced by static slices: the
    Python loop below unrolls at trace time into one fused XLA kernel.

    Parameters for a composite are a tuple ``(left_params, right_params)``.
    """

    left: Sde
    right: Sde

    param_type = tuple

    @property
    def dim(self) -> int:
        return self.left.dim + self.right.dim

    def _split(self, x):
        return x[..., : self.left.dim], x[..., self.left.dim:]

    def validate(self, p) -> None:
        if not (isinstance(p, tuple) and len(p) == 2):
            raise TypeError("CompositeSde expects a (left, right) parameter tuple")
        self.left.validate(p[0])
        self.right.validate(p[1])

    def initial_state(self, p, key, shape=()):
        kl, kr = jax.random.split(key)
        return jnp.concatenate(
            [self.left.initial_state(p[0], kl, shape),
             self.right.initial_state(p[1], kr, shape)],
            axis=-1)

    def step(self, p, key, x, dt):
        kl, kr = jax.random.split(key)
        xl, xr = self._split(x)
        return jnp.concatenate(
            [self.left.step(p[0], kl, xl, dt),
             self.right.step(p[1], kr, xr, dt)],
            axis=-1)

    def step_t(self, p, key, x_t, dt):
        kl, kr = jax.random.split(key)
        xl = x_t[: self.left.dim]
        xr = x_t[self.left.dim:]
        return jnp.concatenate(
            [self.left.step_t(p[0], kl, xl, dt),
             self.right.step_t(p[1], kr, xr, dt)],
            axis=0)

    def transition_coeffs(self, p, dt):
        al, bl, ql = self.left.transition_coeffs(p[0], dt)
        ar, br, qr = self.right.transition_coeffs(p[1], dt)
        return (jnp.concatenate([al, ar]), jnp.concatenate([bl, br]),
                jnp.concatenate([ql, qr]))

    def initial_moments(self, p):
        ml, cl = self.left.initial_moments(p[0])
        mr, cr = self.right.initial_moments(p[1])
        return jnp.concatenate([ml, mr]), jnp.concatenate([cl, cr])

    def drift(self, p, x):
        xl, xr = self._split(x)
        return jnp.concatenate(
            [self.left.drift(p[0], xl), self.right.drift(p[1], xr)], axis=-1)

    def diffusion(self, p, x):
        xl, xr = self._split(x)
        return jnp.concatenate(
            [self.left.diffusion(p[0], xl), self.right.diffusion(p[1], xr)],
            axis=-1)


# -- constructors (reference: Sde.scala:181-202) --------------------------------


def brownian_motion(dim: int) -> Brownian:
    return Brownian(dim)


def gen_brownian_motion(dim: int) -> GenBrownian:
    return GenBrownian(dim)


def ou_process(dim: int) -> Ou:
    return Ou(dim)


def compose_sde(left: Sde, right: Sde) -> CompositeSde:
    """``sde1 |+| sde2``: independent block-diagonal composition."""
    return CompositeSde(left, right)
