"""The async mode's worker threads (port of backend/async_mapper.py).

The reference runs LocalMapping and LoopClosing on threads of their own with
a keyframe queue, and spawns a further thread per global BA (System.cc:
142-148, LocalMapping.cc:528-709, LoopClosing.cc:556).  As in the JAX
package:

- the **mapping worker** takes keyframes off the queue and drives
  ``SlamSystem._mapping_steps`` step by step (triangulation, fusion,
  culling, the local BA in chunks that poll the tracker's ``abort_ba``);
- the **loop worker** takes the keyframes the mapping worker finished and
  runs ``_try_close_loop``: detection and Sim3 outside the lock, the
  correction under ``paused()``, then the GBA thread;
- the **GBA thread** (``SlamSystem._launch_gba``) adjusts a snapshot of the
  map while mapping goes on, and merges under the lock unless its epoch
  moved.

Every mutation of ``system.map`` happens under ``write_lock``: the mapping
worker takes it per mutation (dispatch and the swap), the tracker for the
keyframe insertion, loop correction and the GBA merge for their
writebacks.  The tracker's per-frame visibility counters are buffered and
flushed at the keyframe insertion.

On the card each worker runs on a CUDA stream of its own (``system.
_streams``: "mapping", "loop", "gba"), so its kernels can overlap the
tracker's.  A PyTorch tensor made on one stream is not ready on another:
the system publishes each map with an event recorded on the writer's
stream, and a reader waits for it (``SlamSystem.map``).  On the CPU there
is no stream and the same code runs under a null context.

Beyond the JAX class: ``stopped()`` parks the mapping worker at its next
yield with its stream idle, which the tracker asks for around the capture
of its CUDA graph.  A worker's exception is kept, the worker goes on with
the next keyframe, and ``shutdown`` raises it.
"""

from __future__ import annotations

import contextlib
import queue
import threading


class AsyncMapper:
    def __init__(self, system):
        self.system = system
        self._q: queue.Queue = queue.Queue()
        self._loop_q: queue.Queue = queue.Queue()
        self.write_lock = threading.RLock()
        self._idle = threading.Event()
        self._idle.set()
        self._loop_idle = threading.Event()
        self._loop_idle.set()
        self._exc: BaseException | None = None
        # stopped(): the tracker holds the worker; the worker parks at its
        # next yield, or waits on the queue, and says so
        self._cv = threading.Condition()
        self._hold = False
        self._parked = False
        self._waiting = False
        self._map_thread = threading.Thread(
            target=self._run_mapping, name="local-mapping", daemon=True
        )
        self._loop_thread = threading.Thread(
            target=self._run_loop, name="loop-closing", daemon=True
        )
        self._map_thread.start()
        self._loop_thread.start()

    @property
    def idle(self) -> bool:
        """Mapping-worker idleness, the reference's AcceptKeyFrames gate
        (Tracking.cc:902); loop closing does not block keyframe insertion."""
        return self._idle.is_set()

    def queue_len(self) -> int:
        return self._q.qsize()

    @contextlib.contextmanager
    def paused(self):
        """Hold the map-writer lock: the mapping worker finishes its current
        mutation and blocks before its next one (RequestStop semantics)."""
        with self.write_lock:
            yield

    def submit(self, kf_slot: int):
        self._idle.clear()
        self._q.put(kf_slot)

    def submit_loop(self, kf_slot: int):
        self._loop_idle.clear()
        self._loop_q.put(kf_slot)

    def record_exception(self, e: BaseException):
        """Keep a worker's exception for ``shutdown`` (the first one wins)."""
        if self._exc is None:
            self._exc = e

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Drain mapping, loop closing and any GBA in flight; False when
        ``timeout`` ran out first."""
        ok = self._idle.wait(timeout) and self._loop_idle.wait(timeout)
        gba = self.system._gba_thread
        if gba is not None and gba.is_alive():
            gba.join(timeout)
            ok = ok and not gba.is_alive()
        return ok

    def threads(self) -> list:
        """The worker threads, and the GBA thread if one was started."""
        gba = self.system._gba_thread
        return [self._map_thread, self._loop_thread] + ([gba] if gba is not None else [])

    def shutdown(self):
        """Stop both workers and the GBA thread (joined with timeouts), then
        raise the first exception a worker kept."""
        self._q.put(None)
        self._map_thread.join(timeout=120)
        self._loop_q.put(None)
        self._loop_thread.join(timeout=120)
        gba = self.system._gba_thread
        if gba is not None and gba.is_alive():
            gba.join(timeout=120)
        alive = [t.name for t in self.threads() if t.is_alive()]
        if self._exc is not None:
            raise self._exc
        if alive:
            raise TimeoutError(f"async mode: threads {alive} did not stop within 120 s")

    @contextlib.contextmanager
    def stopped(self, timeout: float = 300.0):
        """The mapping worker parked at its next yield (or waiting for a
        keyframe), its stream idle, until the block ends."""
        with self._cv:
            self._hold = True
            ok = self._cv.wait_for(lambda: self._parked or self._waiting, timeout)
        try:
            if not ok:
                raise TimeoutError(f"the mapping worker did not stop within {timeout} s")
            yield
        finally:
            with self._cv:
                self._hold = False
                self._cv.notify_all()

    def _yield_point(self):
        """Between two mapping steps: park while the tracker holds the
        worker, after the worker's stream has run dry."""
        if not self._hold:
            return
        self.system._sync_stream()
        with self._cv:
            self._parked = True
            self._cv.notify_all()
            self._cv.wait_for(lambda: not self._hold)
            self._parked = False

    def _next_keyframe(self):
        """The mapping worker's next keyframe, marked as waiting meanwhile."""
        with self._cv:
            self._waiting = True
            self._cv.notify_all()
        try:
            return self._q.get()
        finally:
            with self._cv:
                self._waiting = False

    def _run_mapping(self):
        # the worker does not hold write_lock across a keyframe: the system
        # takes it per map mutation, so the tracker's keyframe insertion
        # waits for one mutation, not for the whole keyframe
        with self.system._on_stream("mapping"):
            while True:
                kf = self._next_keyframe()
                if kf is None:
                    return
                try:
                    self._yield_point()
                    for _ in self.system._mapping_steps(kf):
                        self._yield_point()
                    self.system._publish_under_lock()
                    if self.system.loop_closing_enabled:
                        self.submit_loop(kf)
                except Exception as e:   # kept for shutdown; tracking goes on
                    self.record_exception(e)
                finally:
                    if self._q.empty():
                        self._idle.set()

    def _run_loop(self):
        with self.system._on_stream("loop"):
            while True:
                kf = self._loop_q.get()
                if kf is None:
                    return
                try:
                    self.system._try_close_loop(kf)
                except Exception as e:
                    self.record_exception(e)
                finally:
                    if self._loop_q.empty():
                        self._loop_idle.set()
