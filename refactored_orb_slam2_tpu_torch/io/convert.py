"""State carry-across between the JAX package and the port.

``map_state_from_numpy`` / ``frame_from_numpy`` / ``ba_problem_from_numpy``
take the JAX package's ``MapState`` / ``FrameData`` / ``BAProblem`` with
numpy leaves (``jax.tree.map(np.asarray, x)``, or any object or mapping with
the same field names) and build the port's; ``map_state_to_numpy`` goes
back.  A ``MapState`` crosses with every bank, so a map that a JAX run
built over several keyframes (covisibility, observations, parents) arrives
whole.  Descriptor banks cross as numpy
views: the JAX package's ``uint32`` words become the port's ``int32`` words
with the same bits, and back.  ``config_from_reference`` does the same for
settings: the JAX package's ``SystemConfig`` becomes the port's.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .. import config as C
from ..frontend.frame import FrameData
from ..models.map_state import MapState
from ..optim.bundle_adjustment import BAProblem

_DESC_FIELDS = ("kf_desc", "pt_desc", "desc")


def config_from_reference(cfg):
    """The port's config from the JAX package's: a ``SystemConfig`` or one of
    its parts (any dataclass whose class and field names match a class of
    ``config.py``), so both packages compute from the same settings.  An
    unknown class or field raises."""
    cls = getattr(C, type(cfg).__name__)
    return cls(**{
        f.name: (config_from_reference(v) if dataclasses.is_dataclass(v) else v)
        for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]})


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _to_tensor(name: str, a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if name in _DESC_FIELDS:
        if a.dtype not in (np.uint32, np.int32):
            raise TypeError(f"{name}: expected uint32 or int32 words, got {a.dtype}")
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def _field_names(cls):
    if dataclasses.is_dataclass(cls):
        return [f.name for f in dataclasses.fields(cls)]
    return list(cls._fields)                      # a NamedTuple


def _from(cls, obj, device):
    return cls(**{name: _to_tensor(name, _get(obj, name), device)
                  for name in _field_names(cls)})


def map_state_from_numpy(obj, device="cpu") -> MapState:
    """The port's ``MapState`` from numpy banks with the JAX field names."""
    return _from(MapState, obj, device)


def frame_from_numpy(obj, device="cpu") -> FrameData:
    """The port's ``FrameData`` from numpy arrays with the JAX field names."""
    return _from(FrameData, obj, device)


def ba_problem_from_numpy(obj, device="cpu") -> BAProblem:
    """The port's ``BAProblem`` from numpy arrays with the JAX field names."""
    return _from(BAProblem, obj, device)


def map_state_to_numpy(state: MapState) -> dict:
    """{field: numpy array} with descriptor banks as ``uint32`` words, the
    JAX package's layout."""
    out = {}
    for f in dataclasses.fields(MapState):
        a = getattr(state, f.name).cpu().numpy()
        out[f.name] = a.view(np.uint32) if f.name in _DESC_FIELDS else a
    return out
