"""Leaf-wise helpers over the port's containers.

The JAX package keeps its data in pytrees (flax `struct.PyTreeNode`,
NamedTuples).  The port keeps the same shapes in dataclasses and
NamedTuples of tensors; these helpers map a function over their tensor
leaves (non-tensor fields such as `contact_model` pass through).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def map_tensors(fn: Callable[..., Any], obj, *others):
    """Apply fn to every tensor leaf of obj (and the matching leaves of
    `others`, which share obj's structure)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, *others)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(fn, getattr(obj, f.name),
                                *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):   # NamedTuple
        return type(obj)(*(map_tensors(fn, *parts)
                           for parts in zip(obj, *others)))
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(fn, *parts)
                         for parts in zip(obj, *others))
    return obj


def to_device(obj, device):
    """Move every tensor leaf to `device` (one explicit host->device copy
    of the problem data)."""
    return map_tensors(lambda t: t.to(device), obj)


def select(flag: torch.Tensor, new, old):
    """Per-lane select over matching structures: where `flag[b]` take the
    leaves of `new`, else `old`.  flag: (B,) bool; every leaf has a
    leading B axis."""
    def pick(a, b):
        return torch.where(flag.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    return map_tensors(pick, new, old)
