"""Faults planted under a run to show that ``correct`` catches them: the
fault test (``tests/test_slambench_run.py``), the card test
(``tests/test_slambench_control.py``) and the readings of ``control.py``.
Each takes ``patch(owner, name, value)``, which replaces an attribute until
the caller restores it (pytest's ``monkeypatch.setattr`` or
``control.Patches``)."""

from __future__ import annotations

BIG = 1 << 20


def frozen_state(patch):
    """A step that returns its state unchanged: every frame logs the pose
    of the frame before it."""
    from refactored_orb_slam2_tpu_torch.system import SlamSystem

    log_frame = SlamSystem._log_frame

    def frozen(self, *a, **kw):
        log_frame(self, *a, **kw)
        if len(self.trajectory) > 1 and not self.trajectory[-1].lost:
            prev, log = self.trajectory[-2], self.trajectory[-1]
            log.Tcr, log.ref_kf = prev.Tcr, prev.ref_kf

    patch(SlamSystem, "_log_frame", frozen)


def half_skipped(patch):
    """Half of the batch left out: every second frame fed returns at once,
    untracked and unlogged."""
    from refactored_orb_slam2_tpu_torch.system import SlamSystem

    track_entry = SlamSystem._track_entry
    fed = [0]

    def every_other(self, *a, **kw):
        fed[0] += 1
        return None if fed[0] % 2 == 0 else track_entry(self, *a, **kw)

    patch(SlamSystem, "_track_entry", every_other)


def _matchers(patch, alter):
    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming

    for name in ("window_match", "hamming_best2"):
        fn = getattr(cuda_hamming, name)
        patch(cuda_hamming, name, lambda *a, _fn=fn: alter(*(t.clone() for t in _fn(*a))))


def half_rows(patch):
    """Half of the batch left out: the matchers answer the first half of
    their rows and leave the rest without a match."""
    def alter(d1, i1, d2):
        h = len(d1) // 2
        d1[h:], i1[h:], d2[h:] = BIG, 0, BIG
        return d1, i1, d2
    _matchers(patch, alter)


def altered_answer(patch):
    """An answer altered where it is produced: the matchers' first row
    points at the next column."""
    def alter(d1, i1, d2):
        i1[0] += 1
        return d1, i1, d2
    _matchers(patch, alter)


FAULTS = {"frozen_state": frozen_state, "half_skipped": half_skipped,
          "half_rows": half_rows, "altered_answer": altered_answer}
