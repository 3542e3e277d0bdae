import numpy as np

from perfbench import common, traffic


def mix(name):
    return common.mix(name)


def test_variant_batches_are_seeded_and_repeatable():
    a, b = traffic.Traffic(mix("batch256"), 2**31 + 17), traffic.Traffic(mix("batch256"), 2**31 + 17)
    c = traffic.Traffic(mix("batch256"), 5)
    assert a.variant_batch(3) == b.variant_batch(3)
    assert a.variant_batch(3) != c.variant_batch(3)
    texts, variants = a.variant_batch(0)
    assert len(texts) == 256 and all(len(v) == 6 for v in variants)
    assert a.variant_batch(0)[0] != a.variant_batch(1)[0]  # consecutive batches differ


def test_fresh_never_repeats_a_caption_and_warmup_is_apart():
    t = traffic.Traffic(mix("fresh"), 2**32 + 3)
    window = [t.next_batch() for _ in range(100)]  # 19,200 captions
    flat = [c for b in window for c in b]
    assert len(set(flat)) == len(flat)
    warm = {c for b in t.warmup_batches() for c in b}
    assert len(warm) == 2 * 192 and not warm & set(flat)
    assert traffic.Traffic(mix("fresh"), 2**32 + 3).next_batch() == window[0]


def test_fresh_stops_rather_than_repeat():
    t = traffic.Traffic(mix("fresh"), 1)
    n = (len(traffic.distinct_captions()) - 2 * 192) // 192
    for _ in range(n):
        t.next_batch()
    try:
        t.next_batch()
    except RuntimeError:
        return
    raise AssertionError("the fresh mix repeated captions")


def test_cached_draws_only_from_the_pool_set_up_serves():
    t = traffic.Traffic(mix("cached"), 77)
    pool = {c for b in t.warmup_batches() for c in b}
    assert len(t.pool) == 6 * 192 == sum(len(b) for b in t.warmup_batches())
    for _ in range(50):
        b = t.next_batch()
        assert len(b) == 192 and len(set(b)) == 192 and set(b) <= pool


def test_captions_file_is_the_coco_val2017_set():
    caps = traffic.all_captions()
    assert len(caps) == 25014 and len(traffic.caption_groups()) == 5000
    assert len(traffic.distinct_captions()) == 24794


def test_poisson_schedule_rate_and_sizes():
    m = {"arrivals": "poisson", "captions": "uniform", "rate_qps": 2000.0, "zipf_s": 2.0, "max_queries": 16}
    t = traffic.Traffic(m, 9)
    sched = t.schedule(20.0)
    q = sum(len(c) for _, c in sched)
    assert abs(q / 20.0 - 2000.0) / 2000.0 < 0.05
    assert abs(traffic.mean_zipf(2.0, 16) - 2.13) < 0.01
    assert all(1 <= len(c) <= 16 for _, c in sched)
    assert sched == traffic.Traffic(m, 9).schedule(20.0)
    assert np.all(np.diff([d for d, _ in sched]) > 0)


def test_every_seed_gets_the_same_requests_in_another_order():
    m = mix("saturated")
    a, b = traffic.Traffic(m, 3).schedule(30.0), traffic.Traffic(m, 2**31 + 5).schedule(30.0)
    assert len(a) == len(b)
    assert sorted(len(c) for _, c in a) == sorted(len(c) for _, c in b)
    gaps = lambda s: np.sort(np.diff([0.0] + [d for d, _ in s] + [30.0]))  # noqa: E731
    assert np.allclose(gaps(a), gaps(b))
    assert [len(c) for _, c in a] != [len(c) for _, c in b]
    assert all(0.0 < d < 30.0 for d, _ in a)
