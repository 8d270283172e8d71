"""The traffic generator: fixed by the seed, the same work for every
seed."""

import numpy as np

from benchmark import traffic
from benchmark.tests.tiny import OFFLINE, SERVE, TINY_SPECIAL


def _reqs(seed, n=12, block=6, key="k"):
    return traffic.make_requests(OFFLINE, TINY_SPECIAL, 512, 8, seed, block,
                                 n, key=key)


def test_same_seed_same_requests():
    a, b = _reqs(2**31 + 77), _reqs(2**31 + 77)
    assert [(r.tokens, r.voice) for r in a] == [(r.tokens, r.voice)
                                                 for r in b]


def test_other_seed_other_ids_same_lengths():
    a, b = _reqs(1), _reqs(2)
    assert [r.tokens for r in a] != [r.tokens for r in b]
    for lo in (0, 6):
        assert (sorted(len(r.tokens) for r in a[lo:lo + 6])
                == sorted(len(r.tokens) for r in b[lo:lo + 6]))


def test_template_and_range():
    for r in _reqs(5):
        lo, hi = OFFLINE["prompt_tokens"]
        assert lo <= len(r.tokens) <= hi
        assert r.tokens[:3] == [400, 402, 403]
        assert r.tokens[-5:] == [401, 403, 400, 402, 403]
        assert max(r.tokens[3:-5]) < 400
        assert 0 <= r.voice < 8
    assert list(traffic.spread_lengths(16, 64, 49)) == list(range(16, 65))


def test_schedule_fixed_trace(monkeypatch):
    """One arrival trace a mix; the run's seed orders the requests' lengths
    (one of each length in every block of hi - lo + 1) and ids."""
    a = traffic.schedule(SERVE, TINY_SPECIAL, 512, 8, 3, 100.0)
    b = traffic.schedule(SERVE, TINY_SPECIAL, 512, 8, 4, 100.0)
    assert len(a) == len(b) == 400
    assert [r.due for r in a] == [r.due for r in b]
    assert a[0].due == 0.0 and abs(np.mean(np.diff([r.due for r in a]))
                                   - 0.25) < 0.02
    assert [len(r.tokens) for r in a] != [len(r.tokens) for r in b]
    lo, hi = SERVE["prompt_tokens"]
    for rs in (a, b):
        for i in range(0, 400 - 9, 9):
            assert sorted(len(r.tokens) for r in rs[i:i + 9]) == list(
                range(lo, hi + 1))
    monkeypatch.setattr(traffic, "ARRIVAL_SEED", 2)
    other = traffic.schedule(SERVE, TINY_SPECIAL, 512, 8, 3, 100.0)
    assert [r.due for r in other] != [r.due for r in a]


def test_exp_gaps_are_quantiles():
    g = traffic.exp_gaps(2.0, 1000)
    assert abs(g.mean() - 0.5) < 0.01
    assert np.all(np.diff(g) > 0)
