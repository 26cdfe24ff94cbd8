"""The traffic generator: seeded, the same work for every seed, lengths
inside their clipping ranges."""
import collections

import numpy as np
import pytest

from portbench.yardstick import traffic

MIXES = ("chat", "docs")


def _sizes(reqs):
    return collections.Counter((len(r["prompt"]), r["max_new"])
                               for r in reqs)


def _first_batch(mix, seed):
    return next(traffic.batches(mix, seed, 1000))


def _requests(name, seed):
    mix = traffic.load_mix(name)
    if mix["kind"] == "open_loop":
        return traffic.open_loop(mix, seed, 20.0, 1000)
    return _first_batch(mix, seed)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a, b = _requests(name, 7), _requests(name, 7)
    assert [r["arrival"] for r in a] == [r["arrival"] for r in b]
    assert all(np.array_equal(x["prompt"], y["prompt"])
               and x["max_new"] == y["max_new"] for x, y in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_another_seed_other_tokens_same_schedule(name):
    a, b = _requests(name, 7), _requests(name, 2 ** 31 + 11)
    assert any(not np.array_equal(x["prompt"], y["prompt"])
               for x, y in zip(a, b))
    # the same lengths and arrivals: one schedule, other contents
    assert [(r["arrival"], len(r["prompt"]), r["max_new"]) for r in a] \
        == [(r["arrival"], len(r["prompt"]), r["max_new"]) for r in b]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_in_their_ranges(name):
    mix = traffic.load_mix(name)
    for seed in (0, 1, 2):
        for r in _requests(name, seed):
            assert mix["prompt"]["min"] <= len(r["prompt"]) \
                <= mix["prompt"]["max"]
            assert mix["answer"]["min"] <= r["max_new"] \
                <= mix["answer"]["max"]
            assert r["prompt"].min() >= 0 and r["prompt"].max() < 1000


def test_open_loop_fills_the_window_at_the_rate():
    mix = traffic.load_mix("chat")
    reqs = traffic.open_loop(mix, 3, 40.0, 1000)
    t = [r["arrival"] for r in reqs]
    assert len(reqs) == round(mix["rate_rps"] * 40.0)
    assert t == sorted(t) and 0.0 < t[0] and t[-1] < 40.0
    # bursty: the gaps' coefficient of variation is well above Poisson's
    g = np.diff([0.0] + t)
    assert g.std() / g.mean() > 1.3


def test_batches_repeat_the_same_lengths_with_new_tokens():
    mix = traffic.load_mix("docs")
    gen = traffic.batches(mix, 5, 1000)
    a, b = next(gen), next(gen)
    assert len(a) == mix["batch_size"] and _sizes(a) == _sizes(b)
    assert {r["id"] for r in a}.isdisjoint(r["id"] for r in b)
    assert all(r["arrival"] == 0.0 for r in a + b)


def test_train_rows_differ_between_steps_and_rows():
    mix = traffic.load_mix("train")
    a = traffic.train_rows(mix, 9, 0, 50000)
    b = traffic.train_rows(mix, 9, 1, 50000)
    assert a.shape == (mix["batch"], mix["seq"] + 1)
    assert not np.array_equal(a, b)
    assert len({row.tobytes() for row in np.concatenate([a, b])}) \
        == 2 * mix["batch"]
    assert np.array_equal(a, traffic.train_rows(mix, 9, 0, 50000))
