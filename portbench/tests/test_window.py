"""clip_s is the window's whole wall time over the clips its fits
finished, whatever the fits' walls: a stall counts in full."""
from portbench import harness


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _window(walls, seconds, clips=96, gap=0.0):
    clock = Clock()
    script = iter(walls)
    done = []

    def fit():
        clock.t += next(script)
        done.append(1)
        return len(done)

    def after(i, out):
        clock.t += gap

    got, window_s, last = harness.run_window(fit, seconds, after, clock)
    return got, window_s, window_s / (len(got) * clips), last


def test_two_fits_at_least():
    got, window_s, _, last = _window([30.0, 30.0, 30.0], 10.0)
    assert got == [30.0, 30.0] and window_s == 60.0 and last == 2


def test_a_stall_counts_in_full():
    # 10 s fits and one stalled at 30 s, in a 51-s window: after the
    # third fit 50 + 50 / 3 > 51, so three fits ran.
    got, window_s, clip_s, _ = _window([10.0, 10.0, 30.0, 10.0, 10.0], 51.0)
    assert got == [10.0, 10.0, 30.0]
    assert window_s == 50.0
    assert clip_s == 50.0 / (3 * 96)
    # Not the median fit, not the fits' mean without the stall.
    assert clip_s != 10.0 / 96


def test_time_between_fits_counts():
    got, window_s, clip_s, _ = _window([10.0] * 9, 51.0, gap=0.5)
    assert len(got) == 4
    assert window_s == 42.0
    assert clip_s == 42.0 / (4 * 96)
