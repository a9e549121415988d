"""Flat-buffer layout of a parameter tree, shared by the trainer and the kernels.

The reference flattens pytrees into padded (rows, 128) lane views around
every Pallas call and unflattens the result. The port instead keeps the
trainer's state in persistent flat float32 buffers — (n,) for one tree,
(k, n) for k workers — and hands the model per-leaf *views* into them, so
the kernels update the state in place with no copies around the call.

Leaves sit in ``jax.tree.flatten`` order (sorted keys: ``conv1.b,
conv1.w, conv2.b, …``), so the layout equals the reference's
``repro.kernels.flatten`` layout minus its tile padding: the CUDA kernels
mask the tail instead of padding it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.nn.param import tree_from_leaves, tree_leaves


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    offset: int
    size: int

    @property
    def name(self) -> str:
        return ".".join(self.path)


class FlatLayout:
    """Offsets of every leaf of a spec tree inside one flat buffer."""

    def __init__(self, spec_tree):
        leaves: List[Leaf] = []
        off = 0
        for path, spec in tree_leaves(spec_tree):
            leaves.append(Leaf(path, tuple(spec.shape), off, spec.size))
            off += spec.size
        self.leaves = tuple(leaves)
        self.n = off

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(leaf.name for leaf in self.leaves)

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``{name: view}`` into ``flat`` (any leading dims, leaf shape
        appended); writing a view writes the buffer."""
        lead = flat.shape[:-1]
        return {leaf.name: flat[..., leaf.offset:leaf.offset + leaf.size]
                .view(*lead, *leaf.shape) for leaf in self.leaves}

    def pack(self, tensors: Dict[str, torch.Tensor], lead: Tuple[int, ...] = ()
             ) -> torch.Tensor:
        """One ``torch.cat`` of per-leaf tensors (leading dims ``lead``)
        into a new flat float32 buffer."""
        return torch.cat([tensors[leaf.name].reshape(*lead, leaf.size)
                          .to(torch.float32) for leaf in self.leaves], dim=-1)

    def pack_tree(self, tree, lead: Tuple[int, ...] = (), device=None
                  ) -> torch.Tensor:
        """A nested tree (numpy arrays or tensors, reference layout) as a
        flat float32 buffer on ``device``."""
        named = {".".join(path): torch.tensor(np.asarray(leaf))
                 for path, leaf in tree_leaves(tree)}
        if set(named) != set(self.names):
            raise ValueError(
                f"tree leaves {sorted(named)} != layout {list(self.names)}")
        return self.pack(named, lead).to(device)

    def to_numpy(self, flat: torch.Tensor):
        """Nested tree of numpy arrays (reference layout) from a buffer."""
        host = flat.detach().cpu().numpy()
        lead = host.shape[:-1]
        return tree_from_leaves(
            (leaf.path, host[..., leaf.offset:leaf.offset + leaf.size]
             .reshape(*lead, *leaf.shape).copy()) for leaf in self.leaves)
