"""Parameter trees of the port: nested dicts and lists of tensors.

The port's counterpart of the ``jax.tree`` functions it needs.  Dict
leaves come in insertion order, so two trees built the same way flatten
to matching leaves.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


def tree_map(fn: Callable, tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """The tree with ``fn`` applied to every leaf (tuples become lists).

    ``is_leaf``, as in ``jax.tree.map``: a subtree for which it is true is
    handed to ``fn`` whole."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, is_leaf) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """Every leaf of the tree, depth first."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_flatten_with_path(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/0/c": leaf}``: every leaf under its path of dict keys and
    list indices, depth first (the order of :func:`tree_leaves`)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, sub in items:
        out.update(tree_flatten_with_path(sub, f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """The tree with ``fn(path, leaf)`` applied to every leaf, paths as in
    :func:`tree_flatten_with_path` (tuples become lists)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)
