"""Binary composition tree, registered as a JAX pytree.

The reference library composes models, latent states and parameters as binary
trees (reference: Tree.scala:12-108).  In this JAX rebuild the *runtime*
latent state is a flat ``[d_total]`` array (static composition metadata gives
each component a slice), but *parameters* keep the user-facing binary-tree
shape so that composed models are parameterised exactly like the reference:
``params = branch(leaf(p1), leaf(p2))`` mirrors ``m1 |+| m2``.

Because ``Leaf``/``Branch``/``Empty`` are pytree nodes, a parameter tree can be
passed straight through ``jax.jit`` / ``lax.scan`` / ``jax.vmap``, flattened
with ``jax.flatten_util.ravel_pytree`` for MCMC proposals, and checkpointed
with orbax -- the tree *structure* is static trace-time metadata, only the
leaf arrays are traced.
"""

from __future__ import annotations

from typing import Any, Callable

import jax


class Tree:
    """Abstract base for the composition tree."""

    __slots__ = ()

    # -- structural helpers (mirror reference Tree.scala) --------------------

    def flatten(self):
        """Left-to-right list of leaf values.  Reference: Tree.scala:49-53."""
        out = []

        def go(t):
            if isinstance(t, Leaf):
                out.append(t.value)
            elif isinstance(t, Branch):
                go(t.left)
                go(t.right)

        go(self)
        return out

    def get_node(self, n: int):
        """n-th leaf value counting from 0 on the left.  Reference: Tree.scala:26-29."""
        leaves = self.flatten()
        return leaves[n]

    def n_leaves(self) -> int:
        return len(self.flatten())

    def map(self, f: Callable[[Any], Any]) -> "Tree":
        if isinstance(self, Leaf):
            return Leaf(f(self.value))
        if isinstance(self, Branch):
            return Branch(self.left.map(f), self.right.map(f))
        return self

    def zip_with(self, other: "Tree", f: Callable[[Any, Any], Any]) -> "Tree":
        """Shape-checked elementwise combination.  Reference: Tree.scala:58-62."""
        if isinstance(self, Leaf) and isinstance(other, Leaf):
            return Leaf(f(self.value, other.value))
        if isinstance(self, Branch) and isinstance(other, Branch):
            return Branch(
                self.left.zip_with(other.left, f),
                self.right.zip_with(other.right, f),
            )
        if isinstance(self, EmptyTree) and isinstance(other, EmptyTree):
            return self
        raise ValueError(
            f"Tree shapes do not match: {type(self).__name__} vs {type(other).__name__}"
        )

    def fold(self, zero, f: Callable[[Any], Any], combine: Callable[[Any, Any], Any]):
        """Fold over leaves.  Reference: Tree.scala:35-43."""
        if isinstance(self, Leaf):
            return f(self.value)
        if isinstance(self, Branch):
            return combine(
                self.left.fold(zero, f, combine), self.right.fold(zero, f, combine)
            )
        return zero

    def flat_map(self, f: Callable[[Any], "Tree"]) -> "Tree":
        """Substitute each leaf with the tree ``f(value)``.

        Reference: the ``Monad[Tree]`` instance's ``flatMap``
        (Tree.scala:115-137) -- leaves are replaced by whole subtrees,
        branches recurse structurally.
        """
        if isinstance(self, Leaf):
            return f(self.value)
        if isinstance(self, Branch):
            return Branch(self.left.flat_map(f), self.right.flat_map(f))
        return self

    def traverse(self, f: Callable[[Any], Any]) -> Any:
        """Effectful map: ``f`` returns a wrapped value; the results are
        recombined into a tree inside the effect.

        Reference: Tree.traverse (Tree.scala:87-91).  The reference's
        effect is any cats Applicative; here the Python analogs: ``f``
        returning a value => plain map; ``f`` raising => fail-fast
        (the reference's ``Try``); ``f`` returning None => whole-tree
        None (the reference's ``Option``).
        """
        if isinstance(self, Leaf):
            v = f(self.value)
            return None if v is None else Leaf(v)
        if isinstance(self, Branch):
            left = self.left.traverse(f)
            if left is None:
                return None
            right = self.right.traverse(f)
            if right is None:
                return None
            return Branch(left, right)
        return self

    def concat(self, other: "Tree") -> "Tree":
        """``+++`` -- graft ``other`` as the right child.  Reference: Tree.scala:18-20."""
        if isinstance(self, EmptyTree):
            return other
        if isinstance(other, EmptyTree):
            return self
        return Branch(self, other)

    def __add__(self, other: "Tree") -> "Tree":
        """Leafwise addition of identically shaped trees.  Reference: Tree.scala:103-104."""
        return self.zip_with(other, lambda a, b: a + b)

    # structure signature used for validation against a model's composition
    def structure(self) -> Any:
        if isinstance(self, Leaf):
            return "L"
        if isinstance(self, Branch):
            return (self.left.structure(), self.right.structure())
        return "E"


class Leaf(Tree):
    __slots__ = ("value", "_hash")

    def __init__(self, value):
        self.value = value
        self._hash = None

    def __repr__(self):
        return f"Leaf({self.value!r})"

    def __eq__(self, other):
        return isinstance(other, Leaf) and _eq(self.value, other.value)

    def __hash__(self):
        # hash a canonical representation of the value so equal leaves hash
        # equally (the hash/eq contract); cached -- array leaves would
        # otherwise pay a device-to-host copy on every hash call
        if self._hash is None:
            self._hash = hash(("Leaf", _hash_value(self.value)))
        return self._hash


class Branch(Tree):
    __slots__ = ("left", "right")

    def __init__(self, left: Tree, right: Tree):
        self.left = left
        self.right = right

    def __repr__(self):
        return f"Branch({self.left!r}, {self.right!r})"

    def __eq__(self, other):
        return (
            isinstance(other, Branch)
            and self.left == other.left
            and self.right == other.right
        )

    def __hash__(self):
        return hash(("Branch", self.left, self.right))


class EmptyTree(Tree):
    __slots__ = ()

    def __repr__(self):
        return "Empty"

    def __eq__(self, other):
        return isinstance(other, EmptyTree)

    def __hash__(self):
        return hash("EmptyTree")


Empty = EmptyTree()


def _eq(a, b):
    """Value equality for leaves: same shape and equal elements, dtype
    insensitive (``1.0 == np.float32(1.0)``).  Deliberately NOT numpy
    broadcast equality -- ``ones(3)`` and ``1.0`` are distinct leaves --
    so equality stays coherent with :func:`_hash_value`."""
    try:
        import numpy as np

        aa, bb = np.asarray(a), np.asarray(b)
        if aa.dtype.kind == "O" or bb.dtype.kind == "O":
            # structured leaf values (e.g. ParamNode): compare as pytrees
            # leafwise -- np's object-array equality would raise for
            # vector-valued fields
            la, sa = jax.tree_util.tree_flatten(a)
            lb, sb = jax.tree_util.tree_flatten(b)
            return sa == sb and len(la) == len(lb) and all(
                _eq(x, y) for x, y in zip(la, lb))
        return aa.shape == bb.shape and bool(np.all(aa == bb))
    except Exception:
        return a == b


def _hash_value(v):
    """Stable value hash consistent with :func:`_eq`: numeric array-likes
    hash by (shape, float64-canonicalised bytes) so dtype never splits
    equal values into different buckets; other values by their own hash;
    unhashable non-arrays collapse to a constant (valid -- equal values
    still collide into the same bucket)."""
    try:
        import numpy as np

        a = np.asarray(v)
        if a.dtype.kind == "O":
            # structured leaf values (e.g. ParamNode): hash as a pytree of
            # numeric leaves (object-array bytes would hash raw pointers,
            # splitting equal values into different buckets)
            leaves, treedef = jax.tree_util.tree_flatten(v)
            return hash((str(treedef),
                         tuple(_hash_value(x) for x in leaves)))
        if a.dtype.kind in "fiub":
            a = a.astype(np.float64)
        elif a.dtype.kind == "c":
            a = a.astype(np.complex128)
        return hash((a.shape, a.tobytes()))
    except Exception:
        try:
            return hash(v)
        except Exception:
            return 0


def leaf(value) -> Leaf:
    return Leaf(value)


def branch(left: Tree, right: Tree) -> Branch:
    return Branch(left, right)


def construct_tree_left(values) -> Tree:
    """Left-fold a list of values into a left-nested tree.

    Reference: Tree.scala:143-145 (``constructTreeLeft``).
    """
    values = list(values)
    if not values:
        return Empty
    t: Tree = Leaf(values[0])
    for v in values[1:]:
        t = Branch(t, Leaf(v))
    return t


# -- pytree registration -----------------------------------------------------

jax.tree_util.register_pytree_node(
    Leaf,
    lambda t: ((t.value,), None),
    lambda aux, children: Leaf(children[0]),
)

jax.tree_util.register_pytree_node(
    Branch,
    lambda t: ((t.left, t.right), None),
    lambda aux, children: Branch(children[0], children[1]),
)

jax.tree_util.register_pytree_node(
    EmptyTree,
    lambda t: ((), None),
    lambda aux, children: Empty,
)
