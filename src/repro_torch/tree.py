"""Trees of tensors - nested dicts and NamedTuples, as the parameter,
optimizer and train-state trees are - walked in the JAX package's order.

jax.tree_util flattens a dict in sorted-key order and a NamedTuple in field
order, and names a leaf by the path to it: a dict key as it is, a
NamedTuple field as "." + its name, joined with "/" (".params/tok/embed",
".opt/.m/blocks/attn/wq").  The port walks its trees the same way, so sums
over leaves run in the same order and checkpoints carry the same keys.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in flatten order; an empty dict has no leaves."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [("." + f, getattr(tree, f)) for f in tree._fields]
    else:
        return [(prefix, tree)]
    out = []
    for name, child in items:
        out += leaves_with_paths(child, f"{prefix}/{name}" if prefix
                                 else name)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def map_tree(fn: Callable, tree, *rest):
    """fn applied leaf by leaf to trees of one structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(map_tree(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                             for f in tree._fields))
    return fn(tree, *rest)


def map_with_paths(fn: Callable, tree, prefix: str = ""):
    """fn(path, leaf) applied leaf by leaf, the paths as leaves_with_paths
    names them; the result has the tree's structure."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, tree[k],
                                  f"{prefix}/{k}" if prefix else str(k))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_paths(
            fn, getattr(tree, f), f"{prefix}/.{f}" if prefix else "." + f)
            for f in tree._fields))
    return fn(prefix, tree)
