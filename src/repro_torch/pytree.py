"""Frozen dataclasses of tensors as pytrees: the port's stand-in for the
reference's `jax.tree_util` over its registered dataclasses.

A leaf is a tensor. Fields that are not tensors (static metadata such as a
tile grid's width) are carried over from the first tree unchanged. The
path-aware functions (`flatten_with_paths`, `unflatten`) also walk dicts
and take numpy leaves: they give a checkpoint's keys and leaf order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch


def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` leafwise over one or more trees of the same structure."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, *parts) for parts in zip(tree, *rest))
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    return tree


def stack(items: Sequence):
    """Stack identically shaped trees on a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *items)


def take(tree, i):
    """Slice index `i` of every leaf's leading axis."""
    return tree_map(lambda x: x[i], tree)


def leaves(tree) -> list:
    """Every tensor leaf of `tree`, in field order."""
    out = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


def tree_map_with_path(fn: Callable, tree, _path: tuple = (), _scalars: bool = True):
    """Apply `fn(path, leaf)` to every leaf, visiting in the order of the
    reference's checkpoint manifests (JAX's `tree_flatten_with_path`): a
    dataclass field's path entry is `.name`, a dict key is bare (keys are
    visited sorted), a sequence index is the bare number; entries are joined
    by '/'. A leaf is a tensor, a numpy array or scalar, or, inside a dict or
    a sequence, a Python number. None holds no leaf; a dataclass field of
    any other type is static metadata, carried over as `tree_map` does."""
    def sub(x, entry, scalars):
        return tree_map_with_path(fn, x, _path + (entry,), scalars)

    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: sub(getattr(tree, f.name), f".{f.name}", False)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        done = {k: sub(tree[k], str(k), True) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(sub(x, str(i), True) for i, x in enumerate(tree))
    if (torch.is_tensor(tree) or isinstance(tree, (np.ndarray, np.generic))
            or (_scalars and isinstance(tree, (bool, int, float)))):
        return fn("/".join(_path), tree)
    return tree


def flatten_with_paths(tree) -> list:
    """[(path, leaf)] in `tree_map_with_path`'s order: the keys and the leaf
    order of a checkpoint manifest (`repro_torch.checkpoint.manager`)."""
    out = []
    tree_map_with_path(lambda key, x: out.append((key, x)) or x, tree)
    return out


def unflatten(like, leaves: Sequence):
    """`like` with its leaves replaced, in `flatten_with_paths` order."""
    it = iter(leaves)

    def take(_key, _x):
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer leaves than the tree holds") from None

    out = tree_map_with_path(take, like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out
