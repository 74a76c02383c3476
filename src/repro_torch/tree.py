"""Trees of tensors in JAX's flatten order.

The reference keeps parameters, optimizer state and checkpoints as JAX
pytrees; these helpers walk the same nestings the same way: dict keys
sorted, tuple, list and NamedTuple fields in order, ``None`` an empty
subtree, anything else a leaf.  So the leaf order of ``(params,
AdamState(step, mu, nu))`` is the reference's, which fixes the order of
``global_norm``'s sum, the optimizer's walk and a checkpoint's arrays.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

# a tree's structure: (kind, dict keys or None, children); kind is "leaf",
# "none", "dict", or the tuple or list type to rebuild
TreeDef = Tuple[Any, Any, tuple]


def _walk(x, leaves: List[Any]) -> TreeDef:
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return ("dict", keys, tuple(_walk(x[k], leaves) for k in keys))
    if isinstance(x, (tuple, list)):
        return (type(x), None, tuple(_walk(c, leaves) for c in x))
    if x is None:
        return ("none", None, ())
    leaves.append(x)
    return ("leaf", None, ())


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    """``(leaves, treedef)`` in JAX's order."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def _build(node: TreeDef, it) -> Any:
    kind, keys, children = node
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(keys, children)}
    vals = [_build(c, it) for c in children]
    if kind is list:
        return vals
    if kind is tuple:
        return tuple(vals)
    return kind(*vals)              # a NamedTuple


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef`` holding ``leaves`` in flatten order."""
    return _build(treedef, iter(leaves))


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
