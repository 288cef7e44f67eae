"""State carry-across between the JAX package and the port.

``map_state_from_numpy`` / ``frame_from_numpy`` / ``orb_features_from_numpy``
/ ``ba_problem_from_numpy`` / ``init_result_from_numpy`` /
``pnp_result_from_numpy`` / ``vocabulary_from_numpy`` take the JAX
package's ``MapState`` / ``FrameData`` / ``OrbFeatures`` / ``BAProblem`` /
``InitResult`` / ``PnPResult`` / ``Vocabulary`` with numpy leaves
(``jax.tree.map(np.asarray, x)``, or any object or mapping with the same
field names) and build the port's; ``keyframe_db_from_numpy`` builds a
``KeyFrameDB`` from a JAX one's vocabulary, ``bow`` and ``valid``;
``map_state_to_numpy`` goes back.  A ``MapState`` crosses with every bank, so a map that a JAX run
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
from ..ops.orb import OrbFeatures
from ..optim.bundle_adjustment import BAProblem
from ..place.keyframe_db import KeyFrameDB
from ..place.vocab import Vocabulary, make_vocabulary
from ..solvers.epnp import PnPResult
from ..solvers.initializer import InitResult

_DESC_FIELDS = ("kf_desc", "pt_desc", "desc", "words")


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


def orb_features_from_numpy(obj, device="cpu") -> OrbFeatures:
    """The port's ``OrbFeatures`` bank from numpy arrays with the JAX field
    names (the input of ``ops.stereo.stereo_match``)."""
    return _from(OrbFeatures, obj, device)


def init_result_from_numpy(obj, device="cpu") -> InitResult:
    """The port's ``InitResult`` from numpy arrays with the JAX field names."""
    return _from(InitResult, obj, device)


def ba_problem_from_numpy(obj, device="cpu") -> BAProblem:
    """The port's ``BAProblem`` from numpy arrays with the JAX field names."""
    return _from(BAProblem, obj, device)


def pnp_result_from_numpy(obj, device="cpu") -> PnPResult:
    """The port's ``PnPResult`` from numpy arrays with the JAX field names."""
    return _from(PnPResult, obj, device)


def vocabulary_from_numpy(obj, device="cpu") -> Vocabulary:
    """The port's ``Vocabulary`` from a JAX one's ``words`` (uint32) and
    ``idf``; the ±1 planes are made anew (the JAX ones are bf16)."""
    return make_vocabulary(_to_tensor("words", _get(obj, "words"), device),
                           _to_tensor("idf", _get(obj, "idf"), device))


def keyframe_db_from_numpy(obj, device="cpu") -> KeyFrameDB:
    """A ``KeyFrameDB`` from a JAX one (or anything with its ``vocab``,
    ``bow`` and ``valid``): the same vocabulary, bank and valid mask."""
    bow = _to_tensor("bow", _get(obj, "bow"), device)
    db = KeyFrameDB(vocabulary_from_numpy(_get(obj, "vocab"), device), bow.shape[0])
    db.bow.copy_(bow)
    db.valid.copy_(_to_tensor("valid", _get(obj, "valid"), device))
    return db


def map_state_to_numpy(state: MapState) -> dict:
    """{field: numpy array} with descriptor banks as ``uint32`` words, the
    JAX package's layout."""
    out = {}
    for f in dataclasses.fields(MapState):
        a = getattr(state, f.name).cpu().numpy()
        out[f.name] = a.view(np.uint32) if f.name in _DESC_FIELDS else a
    return out
