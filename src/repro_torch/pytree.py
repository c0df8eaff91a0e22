"""Frozen dataclasses of tensors as pytrees: the port's stand-in for the
reference's `jax.tree_util` over its registered dataclasses.

A leaf is a tensor. Fields that are not tensors (static metadata such as a
tile grid's width) are carried over from the first tree unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

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
