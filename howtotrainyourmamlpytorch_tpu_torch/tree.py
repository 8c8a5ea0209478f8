"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Parameters, LSLR vectors and BN state are nested dicts of tensors keyed
like the JAX package's (``conv0/w``, ``norm0/gamma``, ``linear/b``...).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

Tree = Dict[str, Any]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def stack_tasks(tree: Tree, num_tasks: int) -> Tree:
    """Give every leaf a leading task axis of ``num_tasks`` (a broadcast
    view: no copy until a task-specific value is written)."""
    return tree_map(lambda v: v.unsqueeze(0).expand(num_tasks, *v.shape),
                    tree)


def stack(trees: List[Tree]) -> Tree:
    """Stack per-task trees on a new leading task axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def index(tree: Tree, i: int) -> Tree:
    """Task ``i`` of a task-stacked tree, as its own tensors."""
    return tree_map(lambda v: v[i].clone(), tree)
