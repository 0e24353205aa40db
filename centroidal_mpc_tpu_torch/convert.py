"""Build the port's containers from plain numpy data.

The parity tests take a problem built by the JAX package, turn its leaves
into numpy arrays and its settings dataclasses into dicts of fields, and
pass them here, so that both packages solve the very same problem.  This
module takes numpy arrays, Python values and dicts only (never a JAX
object) and returns tensors on a given device and dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch


def to_tensor(a, device, dtype: torch.dtype = torch.float64):
    """A numpy array as a tensor: floating arrays take `dtype`, integer and
    boolean arrays keep their kind (int32 stays int32)."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return torch.tensor(a, dtype=dtype, device=device)
    return torch.tensor(a, device=device)


def from_numpy(cls, fields: Mapping[str, Any], device,
               dtype: torch.dtype = torch.float64):
    """Instantiate a dataclass or NamedTuple of the port (ContactSchedule,
    CentroidalModel, OcpConfig, TrajectoryData, BlockQP, WVars, ZGroups,
    the plant's ClosedLoopReferences and TerrainArrays, ...) from a dict
    of field values: numpy arrays become tensors, other values (static
    fields such as `contact_model`) pass through."""
    return cls(**{k: (to_tensor(v, device, dtype)
                      if isinstance(v, (np.ndarray, np.generic)) else v)
                  for k, v in fields.items()})


def settings_from_dict(cls, fields: Mapping[str, Any]):
    """Instantiate a settings dataclass (QPSettings, ScpSettings) from a
    dict of its fields, as `dataclasses.asdict` gives them; nested
    settings dataclasses are rebuilt from their nested dicts."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            continue
        v = fields[f.name]
        if isinstance(v, Mapping) and dataclasses.is_dataclass(f.default):
            v = settings_from_dict(type(f.default), v)
        kwargs[f.name] = v
    return cls(**kwargs)
