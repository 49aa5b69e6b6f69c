"""Composable state-space models: the semigroup composition operator.

The reference composes models at runtime with a binary operator ``|+|`` over
closures and state trees (Model.scala:96-136).  Here composition is *static
trace-time metadata*:

* a model is a frozen dataclass tree (:class:`LeafModel` / :class:`ComposedModel`)
  -- hashable, usable as a ``jit`` static argument;
* the composed latent state is a flat ``[..., d_total]`` array; every
  component owns a contiguous slice, so the composed SDE transition compiles
  to one fused kernel (see :mod:`.sde`);
* the composed linear transform ``f(x, t)`` is a dot product with a
  time-dependent **design vector** ``F(t) [d_total]`` -- for a particle block
  it is ``particles @ F(t)``, a single contraction, instead
  of the reference's per-particle tree folds (Model.scala:122-128);
* composition is left-biased exactly as the reference: the *leftmost* leaf
  supplies the observation distribution, link and data-likelihood
  (Model.scala:117-133); ``f`` is the sum of componentwise contributions;
  the SDE is the block-diagonal composition.

Parameters for a composed model form a binary :class:`~.tree.Tree` of
:class:`~.params.ParamNode` whose shape matches the model composition, just
like the reference's ``Branch(lp, rp)`` parameters.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp

from . import observation as obs_mod
from .observation import ObservationFamily
from .params import ParamNode
from .sde import CompositeSde, Sde, compose_sde
from .tree import Branch, Leaf, Tree

# the weight contraction's precision (see Model.f)
_HIGHEST = jax.lax.Precision.HIGHEST

# ---------------------------------------------------------------------------
# Linear transforms f (the time-dependent design vector)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FirstElement:
    """f(x, t) = x[0]: pick the first element of the component's state slice.

    Reference: the ``s.fold(0.0)(x => x(0))(_ + _)`` pattern used by every
    non-seasonal model (e.g. Model.scala:250, 271).
    """

    def design(self, dim: int, t):
        e = jnp.zeros((dim,), dtype=jnp.result_type(float))
        return e.at[0].set(1.0)


@dataclasses.dataclass(frozen=True)
class Fourier:
    """Seasonal Fourier design vector.

    f(x, t) = sum_{a=1..h} [cos(2 pi a t / period) * x[2a-2]
                            + sin(2 pi a t / period) * x[2a-1]]

    Reference: SeasonalModel.buildF, Model.scala:217-225.
    """

    period: int
    harmonics: int

    def design(self, dim: int, t):
        freq = 2.0 * jnp.pi / self.period
        a = jnp.arange(1, self.harmonics + 1, dtype=jnp.result_type(float))
        ang = freq * a * t
        # interleave cos/sin exactly as the reference flatMap
        return jnp.stack([jnp.cos(ang), jnp.sin(ang)], axis=-1).reshape(-1)


# ---------------------------------------------------------------------------
# Model specs
# ---------------------------------------------------------------------------


class Model:
    """Base class for model specs (static, hashable trace-time metadata)."""

    # -- structure ------------------------------------------------------------

    def components(self) -> List["LeafModel"]:
        raise NotImplementedError

    def structure(self):
        raise NotImplementedError

    @property
    def sde(self) -> Sde:
        raise NotImplementedError

    @property
    def dim(self) -> int:
        return self.sde.dim

    def slices(self) -> List[Tuple[int, int]]:
        """(offset, dim) of each component's slice of the flat state."""
        out, off = [], 0
        for c in self.components():
            out.append((off, c.sde.dim))
            off += c.sde.dim
        return out

    def __add__(self, other: "Model") -> "ComposedModel":
        """The semigroup operator ``|+|`` (left-biased).

        Reference: Model.scala:96-136.
        """
        return ComposedModel(self, other)

    # -- parameter plumbing -----------------------------------------------------

    def validate_params(self, params: Tree) -> None:
        """Construction-time validation replacing the reference's
        ReaderT[Try] fail-fast model building (Model.scala:44-91,135)."""
        raise NotImplementedError

    def sde_params(self, params: Tree):
        """Map the parameter tree onto the nested tuple structure the
        (composite) SDE expects."""
        raise NotImplementedError

    def _leftmost_node(self, params: Tree) -> ParamNode:
        # a bare ParamNode is a valid single-leaf parameter (accepted by
        # validate_params / sde_params -- the reference's Parameters.apply
        # leaf ctor, Parameters.scala:20-22)
        if isinstance(params, ParamNode):
            return params
        t = params
        while isinstance(t, Branch):
            t = t.left
        if not isinstance(t, Leaf):
            raise TypeError("parameter tree has no leftmost leaf")
        return t.value

    # -- observation layer (left-biased: leftmost leaf) --------------------------
    # (``obs`` is a field on LeafModel and a property on ComposedModel)

    def obs_scale(self, params: Tree):
        """Constrained observation scale of the leftmost component (or 1.0)."""
        node = self._leftmost_node(params)
        if not self.obs.needs_scale:
            return jnp.asarray(1.0, dtype=jnp.result_type(float))
        if node.scale is None:
            raise ValueError(
                f"{type(self.obs).__name__} requires an observation scale "
                "parameter but ParamNode.scale is None")
        return self.obs.constrain_scale(node.scale)

    def link(self, gamma):
        return self.obs.link(gamma)

    def log_density(self, params: Tree, gamma, y):
        """log pi(y | gamma) -- the reference ``dataLikelihood``."""
        return self.obs.log_density(gamma, y, self.obs_scale(params))

    def sample_obs(self, key, params: Tree, gamma):
        return self.obs.sample(key, gamma, self.obs_scale(params))

    # -- latent dynamics ----------------------------------------------------------

    def initial_state(self, params: Tree, key, shape=()):
        return self.sde.initial_state(self.sde_params(params), key, shape)

    def step(self, params: Tree, key, x, dt):
        return self.sde.step(self.sde_params(params), key, x, dt)

    # -- transposed [dim, N] layout (particle axis last) ----------------------

    def initial_state_t(self, params: Tree, key, n: int):
        return self.sde.initial_state_t(self.sde_params(params), key, n)

    def step_t(self, params: Tree, key, x_t, dt):
        return self.sde.step_t(self.sde_params(params), key, x_t, dt)

    def f_t(self, x_t, t):
        """gamma [N] from a transposed [dim, N] particle block."""
        return jnp.matmul(self.design_vector(t), x_t, precision=_HIGHEST)

    # -- linear transform f ----------------------------------------------------------

    def design_vector(self, t):
        """F(t) with gamma = x @ F(t).  Concatenation of componentwise designs."""
        parts = [c.ftype.design(c.sde.dim, t) for c in self.components()]
        return jnp.concatenate(parts, axis=-1)

    def f(self, x, t):
        """gamma = f(x, t): one contraction over the flat state.

        Reference semantics: sum of componentwise f over the state tree
        (Model.scala:122-128).  The contraction is pinned to full float32
        precision: a GPU may otherwise run it in TF32 (about three decimal
        digits), which would shift every particle's weight.  It is a
        d-wide matvec, bound by memory, so the pin costs nothing.
        """
        return jnp.matmul(x, self.design_vector(t), precision=_HIGHEST)

    def component_f(self, x, t, position: int):
        """Transformed state of the ``position``-th component alone.

        Reference: SimulateData.getState, Data.scala:241-244.
        """
        comps = self.components()
        off, d = self.slices()[position]
        return jnp.matmul(x[..., off:off + d],
                          comps[position].ftype.design(d, t),
                          precision=_HIGHEST)

    def decompose(self, x, t):
        """Per-component gamma contributions, [..., n_components]."""
        return jnp.stack(
            [self.component_f(x, t, i) for i in range(len(self.components()))],
            axis=-1)


@dataclasses.dataclass(frozen=True)
class LeafModel(Model):
    obs: ObservationFamily
    _sde: Sde
    ftype: object  # FirstElement | Fourier

    @property
    def sde(self) -> Sde:
        return self._sde

    def components(self) -> List["LeafModel"]:
        return [self]

    def structure(self):
        return "L"

    def validate_params(self, params: Tree, _is_obs_leaf: bool = True) -> None:
        if isinstance(params, ParamNode):
            params = Leaf(params)
        if not isinstance(params, Leaf):
            raise TypeError(
                "Can't build model from branch parameter "  # Model.scala:46
                f"(got {type(params).__name__} for a leaf model)")
        node = params.value
        if not isinstance(node, ParamNode):
            raise TypeError(f"expected ParamNode leaf, got {type(node).__name__}")
        self._sde.validate(node.sde)
        # only the leftmost leaf supplies the observation layer in a
        # composition (Model.scala:117-133), so only it needs a scale
        if _is_obs_leaf and self.obs.needs_scale and node.scale is None:
            raise ValueError(
                f"{type(self.obs).__name__} requires an observation scale")
        if node.scale is not None and jnp.ndim(node.scale) != 0:
            # a [1]-shaped scale silently broadcasts into every downstream
            # scalar (ll carries, predictive variances) and surfaces as an
            # opaque lax.scan carry-shape error; fail at construction
            raise ValueError(
                "observation scale must be a scalar, got shape "
                f"{jnp.shape(node.scale)}")
        if isinstance(self.ftype, Fourier):
            want = 2 * self.ftype.harmonics
            if self._sde.dim != want:
                raise ValueError(
                    f"seasonal model with {self.ftype.harmonics} harmonics "
                    f"needs a {want}-dimensional SDE, got {self._sde.dim}")

    def sde_params(self, params: Tree):
        if isinstance(params, ParamNode):
            return params.sde
        if isinstance(params, Leaf):
            return params.value.sde
        raise TypeError("Can't build model from branch parameter")


@dataclasses.dataclass(frozen=True)
class ComposedModel(Model):
    left: Model
    right: Model

    @property
    def obs(self) -> ObservationFamily:
        """Left-biased: the leftmost leaf supplies the observation layer
        (Model.scala:117-133)."""
        return self.components()[0].obs

    @property
    def sde(self) -> CompositeSde:
        return compose_sde(self.left.sde, self.right.sde)

    def components(self) -> List[LeafModel]:
        return self.left.components() + self.right.components()

    def structure(self):
        return (self.left.structure(), self.right.structure())

    def validate_params(self, params: Tree, _is_obs_leaf: bool = True) -> None:
        if not isinstance(params, Branch):
            raise TypeError(
                "Can't build composed model from leaf parameter")  # Model.scala:135
        self.left.validate_params(params.left, _is_obs_leaf)
        self.right.validate_params(params.right, False)

    def sde_params(self, params: Tree):
        if not isinstance(params, Branch):
            raise TypeError("Can't build composed model from leaf parameter")
        return (self.left.sde_params(params.left),
                self.right.sde_params(params.right))


# ---------------------------------------------------------------------------
# Named constructors (reference: Model.scala:44-91)
# ---------------------------------------------------------------------------


def poisson(sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.Poisson(), sde, FirstElement())


def linear(sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.Gaussian(), sde, FirstElement())


def seasonal(period: int, harmonics: int, sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.Gaussian(), sde, Fourier(period, harmonics))


def students_t(sde: Sde, df: int = 4) -> LeafModel:
    return LeafModel(obs_mod.StudentsT(df), sde, FirstElement())


def bernoulli(sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.Bernoulli(), sde, FirstElement())


def beta(sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.Beta(), sde, FirstElement())


def negative_binomial(sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.NegativeBinomial(), sde, FirstElement())


def zero_inflated_poisson(sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.ZeroInflatedPoisson(), sde, FirstElement())


def lgcp(sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.LogGaussianCox(), sde, FirstElement())


def compose(m1: Model, m2: Model) -> ComposedModel:
    """``m1 |+| m2``: left-biased model composition (Model.scala:110-136)."""
    return ComposedModel(m1, m2)
