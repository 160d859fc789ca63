"""The window's arithmetic: rates over all the window, tails over every
sample; a stall inside the window moves them."""

import types

import pytest

from bench import window


def _track(stamps, submit=0.0):
    req = types.SimpleNamespace(generated=[0] * len(stamps))
    tr = window.Track(0, None, submit, req)
    tr.stamps = list(stamps)
    return tr


def _steady(n_req=10, steps=100, dt=0.01, stall_at=None, stall=0.0):
    """n_req requests each getting a token every step of dt seconds (a
    stall of ``stall`` seconds before step ``stall_at``)."""
    t, times = 0.0, []
    for i in range(steps):
        t += dt + (stall if i == stall_at else 0.0)
        times.append(t)
    return [_track(times, submit=0.0) for _ in range(n_req)], times[-1]


def test_rate_counts_all_the_work_over_all_the_time():
    tracks, end = _steady()
    e = window.end_to_end(tracks, 0.0, end)
    assert e["tokens"] == 1000
    assert e["output_tok_per_s"] == pytest.approx(1000 / end)


def test_a_stall_lowers_the_rate():
    tracks, end = _steady(stall_at=50, stall=0.5)
    base, base_end = _steady()
    slow = window.end_to_end(tracks, 0.0, end)["output_tok_per_s"]
    fast = window.end_to_end(base, 0.0, base_end)["output_tok_per_s"]
    assert slow < 0.7 * fast


def test_stalls_move_the_gap_tail():
    steady, end = _steady()
    assert window.end_to_end(steady, 0.0, end)["itl_p95_ms"] == \
        pytest.approx(10.0)
    # a stall in 10 of 100 steps: more than 5% of the gaps
    t, times = 0.0, []
    for i in range(100):
        t += 0.01 + (0.2 if i % 10 == 5 else 0.0)
        times.append(t)
    stalled = [_track(times) for _ in range(10)]
    assert window.end_to_end(stalled, 0.0, t)["itl_p95_ms"] > 100.0


def test_only_what_lies_inside_the_window_counts():
    tr = _track([0.5, 1.5, 2.5, 3.5], submit=0.2)
    assert window.tokens_in([tr], 1.0, 3.0) == 2
    assert window.gaps([tr], 1.0, 3.0) == [pytest.approx(1.0)]
    assert window.ttfts([tr], 1.0, 3.0) == []        # first token before
    assert window.ttfts([tr], 0.0, 3.0) == [pytest.approx(0.3)]


def test_first_token_tail_is_over_every_request():
    tracks = [_track([0.1 * (i + 1) + 0.05], submit=0.1 * i)
              for i in range(95)]
    tracks += [_track([20.0 + i], submit=19.0 + i) for i in range(5)]
    e = window.end_to_end(tracks, 0.0, 100.0)
    assert e["first_tokens"] == 100
    assert 150.0 < e["ttft_p95_ms"] < 1000.0


def test_two_tokens_of_one_step_reach_the_client_together():
    tr = _track([1.0, 1.0, 2.0])
    assert window.gaps([tr], 0.0, 3.0) == [0.0, 1.0]
