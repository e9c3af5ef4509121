"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Backbone and prompt parameters keep the JAX package's schema
(``mvlpt_tpu/core/clip.py:8-29``) as nested ``dict``s of tensors, so a
tree converted from the JAX side lines up key for key. Lists hold the
ModifiedResNet tower's blocks a stage (``core/resnet.py``); their leaves
come in index order, as ``jax.tree_util`` takes them.
"""

from __future__ import annotations

from typing import Callable


def _children(tree):
    """(key, child) pairs of a dict (key-sorted) or a list, else None."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, list):
        return list(enumerate(tree))
    return None


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in key-sorted order, the order ``jax.tree_util`` uses for
    dicts, so leaf lists of both sides line up."""
    children = _children(tree)
    if children is None:
        return [] if tree is None else [tree]
    return [leaf for _, child in children for leaf in tree_leaves(child)]


def tree_keys(tree, prefix: str = "") -> list:
    """The dotted paths of ``tree_leaves(tree)``, in the same order."""
    children = _children(tree)
    if children is None:
        return [] if tree is None else [prefix[:-1]]
    return [key for k, child in children for key in tree_keys(child, f"{prefix}{k}.")]
