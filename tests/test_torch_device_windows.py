"""chip_smoke.py's device timing keeps only whole profiler windows.

``device_windows`` counts, kernel by kernel, what a window of ``iters``
calls recorded against ``iters`` times what one call launches, and keeps a
window only when every count matches: a window that lost some of its
events would give a device time that is too low.  The profiler is replaced
by a scripted one here (CPU only), so each case says exactly which events
each window recorded.
"""

import pytest
import torch

import chip_smoke


def _script(monkeypatch, windows):
    """Make ``_profiled`` return ``windows`` in turn: first the three
    one-call windows, then the windows of ``iters`` calls."""
    it = iter(windows)
    monkeypatch.setattr(chip_smoke, "_profiled", lambda fn, calls: next(it))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)


ONE_CALL = {"tiles": (1, 50.0), "finalize": (1, 2.0), "mean": (1, 1.0)}


def test_windows_that_lost_events_are_run_again(monkeypatch):
    # iters 10: the second window lost two kernels of a call, the third
    # one a whole kernel's events; the median of the three whole windows
    whole = [{"tiles": (10, us), "finalize": (10, 20.0), "mean": (10, 10.0)}
             for us in (500.0, 700.0, 600.0)]
    lost_two = {"tiles": (10, 500.0), "finalize": (9, 18.0),
                "mean": (9, 9.0)}
    lost_kernel = {"tiles": (10, 500.0), "finalize": (10, 20.0)}
    _script(monkeypatch, [ONE_CALL] * 3 + [whole[0], lost_two, lost_kernel,
                                           whole[1], whole[2]])
    ms = chip_smoke.device_ms(lambda: None, iters=10)
    assert ms == pytest.approx((600.0 + 30.0) / 1e3 / 10)


def test_too_few_whole_windows_raise(monkeypatch):
    short = {"tiles": (10, 500.0), "finalize": (10, 20.0), "mean": (8, 8.0)}
    _script(monkeypatch, [ONE_CALL] * 3 + [short] * 9)
    with pytest.raises(RuntimeError, match="0 of 9 windows"):
        chip_smoke.device_ms(lambda: None, iters=10)


@pytest.mark.parametrize("extra", [
    {},                      # the one-call windows all lost "mean"
    {"memset": (1, 1.0)},    # an event of a kernel no call launches
])
def test_a_window_must_match_the_calls_kernel_by_kernel(monkeypatch, extra):
    # the one-call windows name what a call launches; a window of iters
    # calls that recorded another kernel as well is not whole
    one = dict(ONE_CALL)
    if not extra:
        del one["mean"]
    ten = {k: (10 * c, 10 * us) for k, (c, us) in ONE_CALL.items()}
    ten.update(extra)
    _script(monkeypatch, [one] * 3 + [ten] * 9)
    with pytest.raises(RuntimeError, match="whole"):
        chip_smoke.device_windows(lambda: None, iters=10)


def test_a_call_with_no_recorded_event_raises(monkeypatch):
    _script(monkeypatch, [{}] * 3)
    with pytest.raises(RuntimeError, match="no event"):
        chip_smoke.device_windows(lambda: None, iters=10)
