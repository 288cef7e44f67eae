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

The mechanism is ``StepGraph``; ``FusedGraph`` is the tracked frame's own
class, so that whatever wraps ``FusedGraph.run`` to time or record the
tracked frame's replays (``slambench``'s probes do) sees no other graph.
``SlamSystem._ba_chunk`` wraps the local BA's LM chunk in a ``StepGraph``
the same way.

A step may instead be a generator function that yields the arguments of an
eager call (``call``) and is sent its result: local mapping's triangulation
and fusion steps yield at their masked best-2, so that the matcher stays a
call that whatever wraps ``cuda_hamming.hamming_best2`` sees, with its own
inputs and output.  Each stretch between yields is then one CUDA graph, all
in one memory pool (a stretch reads what the one before it left there),
replayed in order with the eager call between them; the call's results are
copied into the next stretch's input buffers.

A kernel wrapper counts a launch when it enqueues the kernel, which inside
a capture happens once, without a launch.  So the counts the capture added
on its own thread are taken back and kept per graph, and every replay adds
them again: the counts stay one per launch that ran, whatever other threads
launch meanwhile.  A capture or a replay that fails raises; nothing falls
back to the eager step.

The step marks its stages with ``stage(name)``: a telemetry span, and
inside a capture the count of kernel, memcpy and memset nodes that the
capturing graph holds at the stage's end (``stages``, read from the CUDA
driver).  The capture is one stream, so the graph is a chain of nodes in
the order they were captured, which ``stages`` also checks: the k-th device
event of a replay is then the k-th node, and the counts at the stage
boundaries split a replay's device time by stage.  A replay runs no Python
of the step, so the marks cost it nothing.

The capture runs in ``capture_error_mode="thread_local"``: in the global
mode a synchronizing call or a ``cudaMalloc`` that another thread makes
during the capture (the async mode's workers) invalidates it.  The async
mode also stops its mapping worker at a yield, with its stream idle, around
the capture (``AsyncMapper.stopped``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import threading

import torch

from ..ops import cuda_hamming
from ..utils import telemetry

#: the CUDA driver's graph node types that a replay runs as device events
#: (CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET)
_WORK_NODES = (0, 1, 2)
_capturing = threading.local()       # .graph: the StepGraph capturing on this thread
_driver = None


@contextlib.contextmanager
def stage(name: str):
    """A stage of the fused step: a span, and inside a capture a mark of
    the capturing graph's work nodes so far (``StepGraph.stages``)."""
    with telemetry.timer(name):
        yield
    graph = getattr(_capturing, "graph", None)
    if graph is not None:
        graph._mark(name)


def _cuda_driver():
    """The CUDA driver's graph queries, bound at first use."""
    global _driver
    if _driver is None:
        lib = ctypes.CDLL("libcuda.so.1")
        ptr, size = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
        lib.cuStreamGetCaptureInfo_v2.argtypes = [
            ptr, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ptr), ctypes.POINTER(ptr), size]
        lib.cuGraphGetNodes.argtypes = [ptr, ptr, size]
        lib.cuGraphGetEdges.argtypes = [ptr, ptr, ptr, size]
        lib.cuGraphNodeGetType.argtypes = [ptr, ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.cuStreamGetCaptureInfo_v2, lib.cuGraphGetNodes, lib.cuGraphGetEdges,
                   lib.cuGraphNodeGetType):
            fn.restype = ctypes.c_int
        _driver = lib
    return _driver


def _check(rc: int, call: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{call} returned CUDA driver error {rc}")


def _capturing_graph(stream) -> int:
    """The graph that ``stream`` is capturing into (a CUgraph handle)."""
    lib = _cuda_driver()
    status, seq = ctypes.c_int(), ctypes.c_uint64()
    graph, deps, n_deps = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_size_t()
    _check(lib.cuStreamGetCaptureInfo_v2(ctypes.c_void_p(stream.cuda_stream),
                                         ctypes.byref(status), ctypes.byref(seq),
                                         ctypes.byref(graph), ctypes.byref(deps),
                                         ctypes.byref(n_deps)), "cuStreamGetCaptureInfo")
    if status.value != 1 or not graph.value:        # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError("the stream is not capturing")
    return graph.value


def _graph_nodes(graph: int) -> list:
    lib = _cuda_driver()
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    return list(nodes[:n.value])


def _node_type(node: int) -> int:
    t = ctypes.c_int()
    _check(_cuda_driver().cuGraphNodeGetType(node, ctypes.byref(t)), "cuGraphNodeGetType")
    return t.value


def _is_chain(graph: int, n_nodes: int) -> bool:
    """Every node but one has exactly one dependency and no node has two
    dependents: the graph runs its nodes one after another."""
    lib = _cuda_driver()
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetEdges(graph, None, None, ctypes.byref(n)), "cuGraphGetEdges")
    src, dst = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
    _check(lib.cuGraphGetEdges(graph, src, dst, ctypes.byref(n)), "cuGraphGetEdges")
    m = n.value
    return (m == max(n_nodes - 1, 0) and len(set(src[:m])) == m
            and len(set(dst[:m])) == m)


def _map_tensors(fn, x):
    """``fn`` on every tensor of a nest of tuples, dicts and dataclasses."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map_tensors(fn, v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _map_tensors(fn, getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        vals = [_map_tensors(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def flat_tensors(x) -> list:
    """Every tensor of a nest of tuples, dicts and dataclasses, in order."""
    out = []
    _map_tensors(out.append, x)
    return out


def drive(gen, call):
    """Run the generator ``gen`` to its end, sending it ``call(*args)``
    for each ``args`` it yields; returns what it returns."""
    out = None
    while True:
        try:
            args = gen.send(out)
        except StopIteration as stop:
            return stop.value
        out = call(*args)


class StepGraph:
    """One CUDA graph of ``step(**inputs)`` (keyword tensors or None, fixed
    shapes), or, where ``step`` is a generator function, one graph for each
    stretch between its yields, with ``call`` made eagerly at each yield
    (module notes).  ``captures`` and ``replays`` count what it did;
    ``launches`` holds the kernel launches of one replay (``call``'s
    excepted: it counts its own); ``stages``, after a capture: ``marks``,
    each ``stage``'s (name, work nodes captured by its end) in order,
    ``nodes``, the graphs' work nodes, and ``chain``, whether each graph is
    one chain (None where libcuda could not be asked)."""

    def __init__(self, step, call=None):
        self.step = step
        self.call = call
        self.graph = None
        self.holes: list = []        # per yield: (its arguments, result buffers, next graph)
        self.static: dict = {}
        self.copied: dict = {}       # name -> (tensor last copied, its _version)
        self.outputs = None
        self.launches: dict = {}
        self.captures = 0
        self.replays = 0
        self.stages = None
        self._seen: set = set()
        self._work = 0

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

    def _eager(self, inputs: dict, results: list):
        """The step run eagerly, ``call`` made at each yield (its results
        appended to ``results``)."""
        if self.call is None:
            return self.step(**inputs)

        def call(*args):
            results.append(self.call(*args))
            return results[-1]
        return drive(self.step(**inputs), call)

    def _capture(self, inputs: dict):
        """Warm-up (this frame's result) and capture, on one side stream."""
        self.static = {name: (None if t is None else t.clone()) for name, t in inputs.items()}
        self.copied = {name: (t, t._version) for name, t in inputs.items() if t is not None}
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        hole_results: list = []
        with torch.cuda.stream(side):
            result = self._eager(self.static, hole_results)
            # the result buffers of each yield, shaped as the warm-up's
            hole_bufs = [_map_tensors(torch.empty_like, r) for r in hole_results]
        main.wait_stream(side)
        # the warm-up's outputs were made on the side stream and live on
        # the main one
        _map_tensors(lambda t: t.record_stream(main), result)

        counted = cuda_hamming.thread_launches()
        # a dead graph (another system's, in a reference cycle) that the
        # collector frees during the capture releases its memory there,
        # which invalidates the capture: collect first, not during it
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        self.stages = dict(marks=[], nodes=None, chain=None)
        self._seen, self._work = set(), 0
        try:
            if self.call is None:
                self.graph = self._capture_stretch(side, None, lambda: self.step(**self.static))
            else:
                self._capture_stretches(side, hole_bufs)
        finally:
            if collecting:
                gc.enable()
        main.wait_stream(side)
        self.launches = {name: n - counted[name]
                         for name, n in cuda_hamming.thread_launches().items()
                         if n != counted[name]}
        for name, n in self.launches.items():
            cuda_hamming.count(name, -n)
        self.captures += 1
        return result

    def _capture_stretch(self, side, pool, fn):
        """One graph of ``fn()`` captured on ``side`` (into ``pool``, or a
        private pool with None); ``fn``'s result becomes ``outputs``."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=side, capture_error_mode="thread_local"):
            _capturing.graph = self
            try:
                self.outputs = fn()
            finally:
                _capturing.graph = None
            self._mark(None)
        return graph

    def _capture_stretches(self, side, hole_bufs) -> None:
        """A generator step's graphs, one a stretch, in one pool: each yield's
        arguments are kept, and its result buffers (``hole_bufs``) are what
        the next stretch is sent."""
        pool = torch.cuda.graph_pool_handle()
        gen = self.step(**self.static)
        graphs, yielded = [], []

        def stretch(sent):
            try:
                yielded.append(gen.send(sent))
            except StopIteration as stop:
                return stop.value
            return None

        graphs.append(self._capture_stretch(side, pool, lambda: stretch(None)))
        for bufs in hole_bufs:
            graphs.append(self._capture_stretch(side, pool, lambda: stretch(bufs)))
        if len(yielded) != len(hole_bufs):
            raise RuntimeError(f"the step yielded {len(yielded)} times under capture, "
                               f"{len(hole_bufs)} times at its warm-up")
        self.graph = graphs[0]
        self.holes = list(zip(yielded, hole_bufs, graphs[1:]))

    def _mark(self, name) -> None:
        """The capturing graph's work nodes so far: at the end of stage
        ``name``, or with None at a graph's end, the total and the chain
        check.  A driver call that fails warns and ends the counting for
        this capture (``chain`` stays None)."""
        if self._seen is None:
            return
        try:
            graph = _capturing_graph(torch.cuda.current_stream())
            nodes = _graph_nodes(graph)
            new = [n for n in nodes if n not in self._seen]
            self._seen.update(new)
            self._work += sum(_node_type(n) in _WORK_NODES for n in new)
            if name is None:
                chain = _is_chain(graph, len(nodes)) and self.stages["chain"] is not False
                self.stages.update(nodes=self._work, chain=chain)
            else:
                self.stages["marks"].append((name, self._work))
        except (OSError, AttributeError, RuntimeError) as e:
            telemetry.warn("graph_stages", f"fused graph stages not counted: {e}")
            self._seen = None

    def run(self, inputs: dict):
        """The step's outputs for ``inputs``: captured at the first call,
        replayed at every later one."""
        if self.graph is None:
            return self._capture(inputs)
        self._load(inputs)
        self.graph.replay()
        for args, bufs, graph in self.holes:
            for buf, out in zip(flat_tensors(bufs), flat_tensors(self.call(*args))):
                buf.copy_(out)
            graph.replay()
        self.replays += 1
        for name, n in self.launches.items():
            cuda_hamming.count(name, n)
        return _map_tensors(torch.clone, self.outputs)


class FusedGraph(StepGraph):
    """The tracked frame's graph (``SlamSystem._graph``)."""
