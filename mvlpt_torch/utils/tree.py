"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Backbone and prompt parameters keep the JAX package's schema
(``mvlpt_tpu/core/clip.py:8-29``) as nested ``dict``s of tensors, so a
tree converted from the JAX side lines up key for key.
"""

from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in key-sorted order, the order ``jax.tree_util`` uses for
    dicts, so leaf lists of both sides line up."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k]))
        return out
    return [] if tree is None else [tree]


def tree_keys(tree, prefix: str = "") -> list:
    """The dotted paths of ``tree_leaves(tree)``, in the same order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_keys(tree[k], f"{prefix}{k}."))
        return out
    return [] if tree is None else [prefix[:-1]]
