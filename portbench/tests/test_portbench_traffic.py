"""The traffic generator repeats exactly from a seed."""
import numpy as np
import pytest

from portbench import seeds, traffic

SPEC = {"loop": "closed", "length": {"dist": "lognormal", "median": 40,
                                     "sigma": 1.0, "min": 2, "max": 200},
        "items": {"dist": "zipf", "exponent": 1.0}}
SEED = 2 ** 31 + 12_345


def _draw(seed, n_items=5000, n=20_000):
    h = traffic.Histories(SPEC, n_items, seed, "cpu")
    h.ensure(n)
    return [h.get(i) for i in range(n)]


def test_histories_repeat_from_the_seed():
    a, b = _draw(SEED), _draw(SEED)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = _draw(SEED + 1)
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_histories_keep_to_their_distributions():
    hist = _draw(SEED)
    lengths = np.array([len(h) for h in hist])
    assert lengths.min() >= 2 and lengths.max() <= 200
    assert 36 <= np.median(lengths) <= 44          # median 40
    ids = np.concatenate(hist)
    assert ids.min() >= 1 and ids.max() <= 5000
    # Zipf(1): rank 1 is drawn about twice as often as rank 2.
    counts = np.bincount(ids, minlength=3)
    assert 1.8 < counts[1] / counts[2] < 2.2


def test_request_i_does_not_depend_on_how_many_were_made():
    few = traffic.Histories(SPEC, 5000, SEED, "cpu")
    few.ensure(10)
    many = traffic.Histories(SPEC, 5000, SEED, "cpu")
    many.ensure(3 * traffic.CHUNK)
    assert all(np.array_equal(few.get(i), many.get(i)) for i in range(10))


@pytest.mark.parametrize("knee,seconds", [(7000.0, 10.0), (125.0, 3.0)])
def test_arrivals_repeat_and_stay_in_the_window(knee, seconds):
    spec = {"arrivals": "poisson", "knee_req_per_s": knee, "load": 0.8}
    a = traffic.arrivals(spec, SEED, seconds)
    assert np.array_equal(a, traffic.arrivals(spec, SEED, seconds))
    assert a.min() >= 0 and a.max() < seconds
    assert np.all(np.diff(a) > 0)
    n = 0.8 * knee * seconds
    assert abs(len(a) - n) < 5 * np.sqrt(n)


def test_a_longer_span_starts_with_the_same_arrivals():
    """A traced run draws arrivals past the window: the window's stay."""
    spec = {"arrivals": "poisson", "knee_req_per_s": 9000.0, "load": 0.8}
    short = traffic.arrivals(spec, SEED, 10.0)
    long = traffic.arrivals(spec, SEED, 14.0)
    assert len(short) > traffic.ARRIVAL_BLOCK
    assert np.array_equal(long[:len(short)], short)
    assert long[len(short)] >= 10.0


def test_streams_of_one_seed_differ():
    assert len({seeds.derive(SEED, t) for t in range(5)}) == 5
    assert seeds.derive(-3, 0) == seeds.derive(2 ** 64 - 3, 0)
