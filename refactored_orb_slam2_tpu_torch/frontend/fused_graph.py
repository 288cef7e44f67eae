"""The tracked frame as one CUDA graph: the port's counterpart of the JAX
package's ``_jit_fused_track`` (``jax.jit`` of ``_build_fused_track.step``,
``refactored_orb_slam2_tpu/system.py:333-470``), "one dispatch per tracked
frame".

``FusedGraph`` wraps a system's graph-safe fused step
(``SlamSystem._fused_step``: a function of tensors only, with nothing baked
in from Python state that changes between frames) in one
``torch.cuda.CUDAGraph``:

- the first call copies its inputs into static buffers and runs the step
  eagerly on a side stream (the warm-up, whose outputs are that frame's
  result): it builds the CUDA kernels and fills the ``lru_cache``d constant
  tables, so that the capture makes no host-to-device copy;
- then it captures the step on the same stream into a private memory pool,
  with Python's cycle collector run before and held off during it;
- every later call copies each input into its buffer only when the tensor
  changed (another tensor, or the same one written in place: its
  ``_version``), replays the graph, and clones the outputs, so that a later
  replay never overwrites a tensor that the map, the tracker's ``last_*``
  or an in-flight pipelined record still holds.

A kernel wrapper counts a launch when it enqueues the kernel, which inside
a capture happens once, without a launch.  So the counts the capture added
on its own thread are taken back and kept per graph, and every replay adds
them again: the counts stay one per launch that ran, whatever other threads
launch meanwhile.  A capture or a replay that fails raises; nothing falls
back to the eager step.

The capture runs in ``capture_error_mode="thread_local"``: in the global
mode a synchronizing call or a ``cudaMalloc`` that another thread makes
during the capture (the async mode's workers) invalidates it.  The async
mode also stops its mapping worker at a yield, with its stream idle, around
the capture (``AsyncMapper.stopped``).
"""

from __future__ import annotations

import dataclasses
import gc

import torch

from ..ops import cuda_hamming


def _map_tensors(fn, x):
    """``fn`` on every tensor of a nest of tuples and dataclasses."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _map_tensors(fn, getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        vals = [_map_tensors(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def flat_tensors(x) -> list:
    """Every tensor of a nest of tuples and dataclasses, in order."""
    out = []
    _map_tensors(out.append, x)
    return out


class FusedGraph:
    """One CUDA graph of ``step(**inputs)`` (keyword tensors or None, fixed
    shapes).  ``captures`` and ``replays`` count what it did; ``launches``
    holds the kernel launches of one replay."""

    def __init__(self, step):
        self.step = step
        self.graph = None
        self.static: dict = {}
        self.copied: dict = {}       # name -> (tensor last copied, its _version)
        self.outputs = None
        self.launches: dict = {}
        self.captures = 0
        self.replays = 0

    def _load(self, inputs: dict) -> None:
        for name, t in inputs.items():
            if t is None:
                continue
            last = self.copied.get(name)
            if last is not None and last[0] is t and last[1] == t._version:
                continue
            buf = self.static[name]
            if buf.shape != t.shape or buf.dtype != t.dtype:
                raise ValueError(f"fused graph input {name}: {tuple(t.shape)} {t.dtype}, "
                                 f"captured as {tuple(buf.shape)} {buf.dtype}")
            buf.copy_(t)
            self.copied[name] = (t, t._version)

    def _capture(self, inputs: dict):
        """Warm-up (this frame's result) and capture, on one side stream."""
        self.static = {name: (None if t is None else t.clone()) for name, t in inputs.items()}
        self.copied = {name: (t, t._version) for name, t in inputs.items() if t is not None}
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            result = self.step(**self.static)
        main.wait_stream(side)
        # the warm-up's outputs were made on the side stream and live on
        # the main one
        _map_tensors(lambda t: t.record_stream(main), result)

        counted = cuda_hamming.thread_launches()
        graph = torch.cuda.CUDAGraph()
        # a dead graph (another system's, in a reference cycle) that the
        # collector frees during the capture releases its memory there,
        # which invalidates the capture: collect first, not during it
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                self.outputs = self.step(**self.static)
        finally:
            if collecting:
                gc.enable()
        main.wait_stream(side)
        self.launches = {name: n - counted[name]
                         for name, n in cuda_hamming.thread_launches().items()
                         if n != counted[name]}
        for name, n in self.launches.items():
            cuda_hamming.count(name, -n)
        self.graph = graph
        self.captures += 1
        return result

    def run(self, inputs: dict):
        """The step's outputs for ``inputs``: captured at the first call,
        replayed at every later one."""
        if self.graph is None:
            return self._capture(inputs)
        self._load(inputs)
        self.graph.replay()
        self.replays += 1
        for name, n in self.launches.items():
            cuda_hamming.count(name, n)
        return _map_tensors(torch.clone, self.outputs)
