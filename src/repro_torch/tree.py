"""Trees of tensors: nested dicts, lists, tuples and NamedTuples, walked in
the order ``jax.tree_util`` flattens the same structure (dict keys sorted,
sequences and NamedTuple fields in order; ``None`` is an empty subtree).
The optimizer, the checkpoint manager and the pruning glue walk the
port's param, score and optimizer-state trees through these."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def flatten_with_path(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """Leaves of ``tree`` with their key paths (dict keys, sequence
    indices, NamedTuple field names)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from flatten_with_path(tree[key], path + (key,))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from flatten_with_path(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from flatten_with_path(sub, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def map_with_path(fn: Callable, tree, path: Path = ()):
    """Rebuild ``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, n), path + (n,))
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def unflatten(tree, new_leaves: List[Any]):
    """``tree``'s structure with its leaves replaced, in flatten order, by
    ``new_leaves``."""
    order = {path: i for i, (path, _) in enumerate(flatten_with_path(tree))}
    if len(order) != len(new_leaves):
        raise ValueError(f"tree has {len(order)} leaves, got "
                         f"{len(new_leaves)}")
    return map_with_path(lambda path, _: new_leaves[order[path]], tree)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (same structure)."""
    others = [leaves(t) for t in rest]
    out = [fn(leaf, *(o[i] for o in others))
           for i, leaf in enumerate(leaves(tree))]
    return unflatten(tree, out)


def path_str(path: Path) -> str:
    return "/".join(str(p) for p in path)
