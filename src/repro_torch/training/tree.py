"""Parameter trees in the reference's leaf order.

A tree is nested dicts and lists (the port's parameter, gradient and
optimizer-state trees) with tensors, numpy arrays or ``None`` at the
leaves, and the pruning metadata (:class:`PrunedHeadState`) as a node
whose children are its array fields; a tuple is a leaf (:func:`unzip`
splits a tree of tuples).  JAX flattens such a tree with dict
keys in sorted order, list items in order, and a ``PrunedHeadState``'s
data fields in their registration order (``ARRAY_FIELDS``), absent
(``None``) fields and ``None`` leaves contributing nothing.  The walks
below follow that order, so sums over leaves (``global_norm``) and
checkpoint keys (``path_str``) match the reference's.

Abstract state (the reference's ``jax.ShapeDtypeStruct`` trees) is a tree
of tensors on ``torch.device("meta")``: shapes and dtypes, no storage.
:func:`eval_shape` is ``jax.eval_shape``: it runs a function under
``FakeTensorMode``, which allocates nothing and draws from no generator,
and returns its output tree on meta.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Tuple

import torch

from repro_torch.core.pruning import ARRAY_FIELDS, PrunedHeadState

Path = Tuple[Any, ...]


def path_str(path: Path) -> str:
    """A tree path as the reference's ``"a/b/0"`` string."""
    return "/".join(str(p) for p in path)


def walk(tree: Any, path: Path = (), owner: Any = None,
         ) -> Iterator[Tuple[Path, Any, Any]]:
    """``(path, leaf, owner)`` for every leaf, in the reference's order;
    ``owner`` is the :class:`PrunedHeadState` whose field the leaf is, else
    ``None``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from walk(v, path + (i,))
    elif isinstance(tree, PrunedHeadState):
        for f in ARRAY_FIELDS:
            yield from walk(getattr(tree, f), path + (f,), tree)
    else:
        yield path, tree, owner


def leaves_with_path(tree: Any, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """``(path, leaf)`` for every leaf, in the reference's order."""
    for p, leaf, _ in walk(tree, path):
        yield p, leaf


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any,
                  path: Path = ()) -> Any:
    """``fn(path, leaf, *others)`` at every leaf of ``tree``, where
    ``others`` are the nodes at the same place in ``rest`` (trees with
    ``tree``'s structure as a prefix, so a leaf of ``tree`` may face a
    subtree there, as Adafactor's per-leaf state dicts do).  Returns a
    tree of ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *[r[k] for r in rest],
                                 path=path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, *[r[i] for r in rest], path=path + (i,))
                for i, v in enumerate(tree)]
    if isinstance(tree, PrunedHeadState):
        return dataclasses.replace(tree, **{
            f: map_with_path(fn, getattr(tree, f),
                             *[getattr(r, f) for r in rest], path=path + (f,))
            for f in ARRAY_FIELDS if getattr(tree, f) is not None})
    return fn(path, tree, *rest)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *others)`` at every leaf (see :func:`map_with_path`)."""
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def unzip(tree: Any, n: int) -> Tuple[Any, ...]:
    """A tree whose leaves are ``n``-tuples -> ``n`` trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))


def meta_like(t: Any) -> Any:
    """A tensor's meta stand-in (same shape and dtype); non-tensors as
    they are."""
    if isinstance(t, torch.Tensor):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    return t


def to_meta(tree: Any) -> Any:
    """Every tensor leaf of ``tree`` as a meta tensor."""
    return tree_map(meta_like, tree)


def eval_shape(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
    """``fn(*args, **kwargs)``'s output tree on meta, computed without
    storage: under ``FakeTensorMode`` every tensor op gives a shape-only
    tensor, and a random draw advances no generator."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        out = fn(*args, **kwargs)
    return to_meta(out)
