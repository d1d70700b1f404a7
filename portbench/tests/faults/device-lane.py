"""The faults of the timed path that a "device-lane" cell (map
--device-exact) can have, each planted by monkeypatch in the run's own
process: portbench/tests/test_pb_faults.py runs each and sees
`correct` come out false."""
from portbench.tests.faults.common import moved


def _stale_exact(monkeypatch):
    """The collate step returns its first batch's outputs for every
    batch."""
    from smalt_tpu_torch.map import fastlane
    real, first = fastlane.DeviceExact._collate_outputs, []

    def outputs(self, dargs):
        got = real(self, dargs)
        if not first:
            first.append(got)
        return first[0]
    monkeypatch.setattr(fastlane.DeviceExact, "_collate_outputs", outputs)


def _exact_text(monkeypatch, change):
    """`change` applied to each batch's text where the exact lane renders
    it: _finish for single reads, the C pair block's _pair_tail for
    pairs (None there: the batch goes to the host)."""
    from smalt_tpu_torch.map import fastlane
    finish, pair_tail = fastlane.DeviceExact._finish, \
        fastlane.DeviceExact._pair_tail
    monkeypatch.setattr(fastlane.DeviceExact, "_finish",
                        lambda self, *a: change(finish(self, *a)))

    def tail(*a):
        text = pair_tail(*a)
        return None if text is None else change(text)
    monkeypatch.setattr(fastlane.DeviceExact, "_pair_tail",
                        staticmethod(tail))


def _altered_exact(monkeypatch):
    """A record altered where the exact lane renders its batch."""
    _exact_text(monkeypatch, moved)


def _half_exact(monkeypatch):
    """The exact lane leaves out the second half of each batch."""
    def half(text):
        lines = text.split("\n")
        return "\n".join(lines[: len(lines) // 2]) + "\n"
    _exact_text(monkeypatch, half)


FAULTS = [_stale_exact, _half_exact, _altered_exact]
