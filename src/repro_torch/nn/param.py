"""Parameter specification trees.

A model declares its parameters as a nested dict of :class:`ParamSpec`
leaves, as in ``repro.nn.param``. Leaves are ordered the way
``jax.tree.flatten`` orders a nested dict — sorted keys at every level — so
the port's flat buffers (``repro_torch.kernels.flatten``) lay the leaves
out exactly as the reference does.

Initialisation draws from an explicit ``torch.Generator`` on the device
the tree is made on (a CUDA generator draws a model's weights on the card)
and cannot reproduce the reference's threefry draws; runs that must match
the reference carry its parameters across with :func:`params_from_numpy`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

Initializer = Callable[[torch.Generator, Sequence[int], torch.dtype],
                       torch.Tensor]


def zeros_init(gen, shape, dtype):
    return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)


def ones_init(gen, shape, dtype):
    return torch.ones(tuple(shape), dtype=dtype, device=gen.device)


def normal_init(stddev: float = 0.02) -> Initializer:
    def init(gen, shape, dtype):
        return (stddev * torch.randn(tuple(shape), generator=gen,
                                     device=gen.device)).to(dtype)

    return init


def fan_in_init(axis: int = -2) -> Initializer:
    """LeCun-normal style: stddev = 1/sqrt(fan_in along ``axis``)."""

    def init(gen, shape, dtype):
        fan_in = shape[axis] if shape else 1
        stddev = 1.0 / math.sqrt(max(1, fan_in))
        return (stddev * torch.randn(tuple(shape), generator=gen,
                                     device=gen.device)).to(dtype)

    return init


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Abstract description of one parameter tensor."""

    shape: tuple
    dtype: Any = torch.bfloat16
    init: Initializer = fan_in_init()

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def tree_leaves(tree, prefix: Tuple[str, ...] = ()
                ) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` pairs of a nested dict in ``jax.tree.flatten``
    order (sorted keys at every level)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out.extend(tree_leaves(tree[key], prefix + (key,)))
    return out


def tree_from_leaves(pairs) -> Dict[str, Any]:
    """Inverse of :func:`tree_leaves`: nested dict from ``(path, leaf)``."""
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def param_count(tree) -> int:
    return sum(s.size for _, s in tree_leaves(tree))


def stack_specs(spec_tree, n: int):
    """Add a leading layer axis of length ``n`` to every leaf; each layer's
    slice is drawn by the leaf's own initializer at the per-layer shape
    (so fan-in counts as in the reference's ``vmap``-ed init)."""
    return tree_from_leaves(
        (path, ParamSpec((n,) + s.shape, s.dtype, _stacked_init(s.init, n)))
        for path, s in tree_leaves(spec_tree))


def _stacked_init(init: Initializer, n: int) -> Initializer:
    def stacked(gen, shape, dtype):
        out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
        for i in range(n):  # layer by layer: no second full-size copy
            out[i] = init(gen, shape[1:], dtype)
        return out

    return stacked


def init_tree(gen: torch.Generator, tree, device=None) -> Dict[str, Any]:
    """Materialize a spec tree on ``device`` (default: the generator's),
    drawing each leaf in leaf order from ``gen``, which must live on that
    device — a CUDA generator draws a model's weights on the card."""
    if device is not None and torch.device(device).type != gen.device.type:
        raise ValueError(f"init_tree: generator on {gen.device}, asked for "
                         f"{torch.device(device)}")
    return tree_from_leaves(
        (path, s.init(gen, s.shape, s.dtype)) for path, s in tree_leaves(tree))


def _from_numpy(leaf) -> torch.Tensor:
    leaf = np.asarray(leaf)
    if leaf.dtype.name == "bfloat16":  # ml_dtypes: carry the bits exactly
        return torch.from_numpy(leaf.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(leaf, copy=True))


def params_from_numpy(tree) -> Dict[str, Any]:
    """A parameter tree of numpy arrays (e.g. the reference's params via
    ``jax.device_get``) as torch tensors on the CPU, in the same layouts and
    dtypes: HWIO conv kernels, (in, out) dense
    weights, no transposes. bfloat16 leaves (``ml_dtypes`` arrays, which
    ``torch.from_numpy`` rejects) arrive through a 16-bit view, bit for
    bit."""
    return tree_from_leaves(
        (path, _from_numpy(leaf))
        for path, leaf in tree_leaves(tree))
