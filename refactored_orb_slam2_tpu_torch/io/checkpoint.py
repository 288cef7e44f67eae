"""Map checkpoint / restore (port of io/checkpoint.py).

One ``np.savez_compressed`` file in the JAX package's format, so that a map
saved by either package loads in the other: ``map_<field>`` for every
``MapState`` field, ``meta`` (a JSON string: ``n_kf``, ``n_pt``,
``ref_kf``, ``sensor``, ``culled_chain``) and, once a vocabulary exists,
``vocab_words``, ``vocab_idf``, ``db_bow`` and ``db_valid``.  Every array
keeps the JAX package's dtype on disk: the port's int32 descriptor words
(``kf_desc``, ``pt_desc``, ``vocab_words``) are written as the uint32 words
they view, and read back as int32 views.

A fresh system is left in ``NOT_INITIALIZED`` by the load, as in the JAX
package (ROADMAP.md, "Faults in the reference itself"): to relocalize
against the loaded map, set ``system.state = TrackState.LOST`` after it.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..models.map_state import MapState
from ..place.keyframe_db import KeyFrameDB
from ..place.vocab import make_vocabulary

# descriptor words: int32 in the port, uint32 on disk as in the JAX package
_WORDS = ("kf_desc", "pt_desc", "vocab_words")


def _host(name: str, t: torch.Tensor) -> np.ndarray:
    """One read of ``t``; descriptor words as the JAX package's uint32."""
    a = t.cpu().numpy()
    return a.view(np.uint32) if name in _WORDS else a


def _device(name: str, a: np.ndarray, device) -> torch.Tensor:
    """One host-to-device copy; uint32 words become int32 views."""
    if name in _WORDS:
        a = np.ascontiguousarray(a).view(np.int32)
    return torch.from_numpy(a).to(device)


def save_map(path: str, system) -> None:
    """Serialize a SlamSystem's map and place-recognition state."""
    arrays = {f"map_{f.name}": _host(f.name, getattr(system.map, f.name))
              for f in dataclasses.fields(MapState)}
    meta = {
        "n_kf": int(system.n_kf),
        "n_pt": int(system.n_pt),
        "ref_kf": int(system.ref_kf),
        "sensor": system.sensor,
        "culled_chain": {
            str(k): [np.asarray(v[0]).tolist(), int(v[1])]
            for k, v in system.culled_chain.items()
        },
    }
    extra = {}
    if system.vocab is not None:
        extra["vocab_words"] = _host("vocab_words", system.vocab.words)
        extra["vocab_idf"] = _host("vocab_idf", system.vocab.idf)
        extra["db_bow"] = _host("db_bow", system.db.bow)
        extra["db_valid"] = _host("db_valid", system.db.valid)
    np.savez_compressed(path, meta=json.dumps(meta), **arrays, **extra)


def load_map(path: str, system) -> None:
    """Restore a map saved by :func:`save_map` (of either package) into a
    SlamSystem built with the same configuration; the capacities must
    match, or ``ValueError`` names the first field that differs."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        host = {}
        for f in dataclasses.fields(MapState):
            arr = z[f"map_{f.name}"]
            cur = getattr(system.map, f.name)
            if arr.shape != tuple(cur.shape):
                raise ValueError(
                    f"capacity mismatch for {f.name}: checkpoint {arr.shape} vs "
                    f"system {tuple(cur.shape)}"
                )
            host[f.name] = arr
        extra = {k: z[k] for k in ("vocab_words", "vocab_idf", "db_bow", "db_valid")
                 if k in z}
    dev = system.device
    system.map = MapState(**{k: _device(k, a, dev) for k, a in host.items()})
    system.n_kf = int(meta["n_kf"])
    system.n_pt = int(meta["n_pt"])
    system.ref_kf = int(meta["ref_kf"])
    system.culled_chain = {
        int(k): (np.asarray(v[0], dtype=np.float32), int(v[1]))
        for k, v in meta["culled_chain"].items()
    }
    if extra:
        system.vocab = make_vocabulary(_device("vocab_words", extra["vocab_words"], dev),
                                       _device("vocab_idf", extra["vocab_idf"], dev))
        system.db = KeyFrameDB(system.vocab, system.cfg.map.max_keyframes)
        system.db.bow = _device("db_bow", extra["db_bow"], dev)
        system.db.valid = _device("db_valid", extra["db_valid"], dev)
