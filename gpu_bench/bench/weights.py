"""Weights made from the seed, on the device, in the type they are served in.

A configuration's reference module lists its leaves (``leaf_specs``): a
path in the program's parameter tree, the shape a layer holds, whether the
leaf is stacked over layers, its dtype and its draw.  Each (leaf, layer)
has a generator of its own, seeded from the run's seed and its name, and
is drawn in one call of ``normal_`` straight into its dtype: the program's
tree is built from those draws, and the reference draws any one of them
again, alone, to work in float32 after the program's state is freed.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

__all__ = ["LeafSpec", "leaf_seed", "draw", "build_params", "Redraw", "DTYPES"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class LeafSpec:
    path: tuple[str, ...]       # keys in the program's parameter tree
    shape: tuple[int, ...]      # one layer's shape (the whole leaf if not stacked)
    stacked: bool               # a leading axis over the layers
    dtype: str                  # a key of DTYPES
    mean: float                 # normal_(mean, std)
    std: float


def leaf_seed(seed: int, path: tuple[str, ...], layer: int) -> int:
    key = f"{seed & (2**64 - 1)}/{'/'.join(path)}/{layer}".encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "little") >> 1


def draw(spec: LeafSpec, seed: int, layer: int, device, out: torch.Tensor | None = None):
    """Layer ``layer``'s slice of ``spec`` (``layer`` 0 for a leaf that is
    not stacked), drawn into ``out`` or a new tensor."""
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, spec.path, layer))
    if out is None:
        out = torch.empty(spec.shape, dtype=DTYPES[spec.dtype], device=device)
    return out.normal_(spec.mean, spec.std, generator=gen)


def build_params(specs: list[LeafSpec], seed: int, n_layers: int, device) -> dict:
    """The program's parameter tree: each stacked leaf (n_layers, *shape)."""
    tree: dict = {}
    for spec in specs:
        lead = (n_layers,) if spec.stacked else ()
        leaf = torch.empty((*lead, *spec.shape), dtype=DTYPES[spec.dtype], device=device)
        for g in range(n_layers if spec.stacked else 1):
            draw(spec, seed, g, device, out=leaf[g] if spec.stacked else leaf)
        node = tree
        for key in spec.path[:-1]:
            node = node.setdefault(key, {})
        node[spec.path[-1]] = leaf
    return tree


class Redraw:
    """The reference's view of the weights: any leaf of any layer drawn
    again from the seed and widened to float32."""

    def __init__(self, specs: list[LeafSpec], seed: int, device):
        self.specs = {s.path: s for s in specs}
        self.seed, self.device = seed, device

    def __call__(self, path: tuple[str, ...], layer: int = 0) -> torch.Tensor:
        return draw(self.specs[path], self.seed, layer, self.device).float()
