"""The faults of the timed path that a "fast" (map --fast) cell can have,
each planted by monkeypatch in the run's own process (its tail workers
are not patched): portbench/tests/test_pb_faults.py runs each and sees
`correct` come out false."""
from portbench.tests.faults.common import moved


def _stale(monkeypatch):
    """The device step returns its first batch's state for every batch."""
    from smalt_tpu_torch.map import fastmode
    real, first = fastmode._InFlight.result, []

    def result(self):
        arr = real(self)
        if not first:
            first.append(arr.copy())
        return first[0]
    monkeypatch.setattr(fastmode._InFlight, "result", result)


def _half(monkeypatch):
    """The step leaves out half of each batch: every other row (pairs:
    both mates of every other pair, rows i and n + i) scores nothing."""
    from smalt_tpu_torch.map import fastmode
    real = fastmode._InFlight.result

    def result(self):
        arr = real(self).copy()
        arr[:, 1::2] = 0
        return arr
    monkeypatch.setattr(fastmode._InFlight, "result", result)


def _altered_fast(monkeypatch):
    """A record altered where the device loop takes it from the tail."""
    from smalt_tpu_torch.map import fastmode
    real = fastmode.TailPool._take
    monkeypatch.setattr(fastmode.TailPool, "_take",
                        lambda self, fut: moved(real(self, fut)))


FAULTS = [_stale, _half, _altered_fast]
