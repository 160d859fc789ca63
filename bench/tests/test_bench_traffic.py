"""The generator: one seed, one traffic; every seed, one multiset of
sizes."""

import numpy as np
import pytest

from bench import spec
from bench.traffic import MIN_OUTPUT, Pool

MIXES = sorted(p.stem for p in (spec.BENCH / "traffic").glob("*.json"))


def _mix(name):
    return spec._read(spec.BENCH / "traffic" / f"{name}.json")


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_traffic(mix):
    a, b = Pool(_mix(mix), 2**31 + 17, 32000), Pool(_mix(mix), 2**31 + 17,
                                                     32000)
    assert np.array_equal(a.prompt_lens, b.prompt_lens)
    assert np.array_equal(a.max_news, b.max_news)
    assert np.array_equal(a.first_news, b.first_news)
    for i in (0, 5, len(a) - 1):
        assert np.array_equal(a.tokens(i), b.tokens(i))


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_share_the_sizes_not_the_order(mix):
    m = _mix(mix)
    a, b = Pool(m, 1, 32000), Pool(m, 2, 32000)
    assert sorted(zip(a.prompt_lens, a.max_news)) == sorted(
        zip(b.prompt_lens, b.max_news))
    assert not np.array_equal(a.prompt_lens, b.prompt_lens)
    assert not np.array_equal(a.tokens(0)[:16], b.tokens(0)[:16])


@pytest.mark.parametrize("mix", MIXES)
def test_sizes_stay_in_the_mix(mix):
    m = _mix(mix)
    p = Pool(m, 3, 50280)
    assert p.prompt_lens.min() >= m["prompt_tokens"]["min"]
    assert p.prompt_lens.max() <= m["prompt_tokens"]["max"]
    assert p.max_news.min() >= max(m["output_tokens"]["min"], MIN_OUTPUT)
    assert p.max_news.max() <= m["output_tokens"]["max"]
    assert p.prompt_lens.max() + p.max_news.max() <= m["max_len"]
    t = p.tokens(1)
    assert t.dtype == np.int32 and t.min() >= 0 and t.max() < 50280


def test_first_wave_is_cut_to_a_residual_length():
    m = _mix("sharegpt_c256")
    p = Pool(m, 4, 50280)
    first = [p.take() for _ in range(p.clients)]
    whole = [p.max_news[s.index % len(p)] for s in first]
    assert all(MIN_OUTPUT <= s.max_new <= w for s, w in zip(first, whole))
    assert np.mean([s.max_new for s in first]) < 0.7 * np.mean(whole)
    later = p.take()
    assert later.max_new == p.max_news[later.index % len(p)]


@pytest.mark.parametrize("mix", MIXES)
def test_requests_take_the_pool_round_after_round(mix):
    m = _mix(mix)
    p = Pool(m, 5, 32000)
    n, c = len(p), p.clients
    i = c + 3 * n + 7
    assert p.spec(i).prompt_len == p.spec(c + 7 + (i - c - 7)).prompt_len
    assert p.spec(i).prompt_len == p.prompt_lens[i % n]
    assert p.spec(i).max_new == p.max_news[i % n]
    assert len(p.tokens(i)) == p.prompt_lens[i % n]
    assert not np.array_equal(p.tokens(i)[:8], p.tokens(i % n)[:8])


def test_log_uniform_quantiles():
    m = {"kind": "closed_loop", "clients": 1, "pool": 1000,
         "prompt_tokens": {"dist": "loguniform", "min": 100, "max": 10000},
         "output_tokens": {"dist": "uniform", "min": 10, "max": 20}}
    p = Pool(m, 0, 10)
    assert abs(np.median(p.prompt_lens) - 1000) <= 10
    assert abs(np.median(p.max_news) - 15) <= 1


@pytest.mark.parametrize("mix", MIXES)
def test_every_mix_has_its_source(mix):
    """Each mix names the public source of its lengths and concurrency,
    and draws its sizes in the seed's order (one rule for every mix)."""
    m = _mix(mix)
    assert m["source"].strip() and m["why"].strip()
    assert "order" not in m
    a, b = Pool(m, 1, 32000), Pool(m, 1, 32000)
    assert np.array_equal(a.first_news, b.first_news)
    assert not np.array_equal(a.first_news, Pool(m, 2, 32000).first_news)
