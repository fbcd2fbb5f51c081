"""The traffic generator: deterministic per seed, the same work on every
seed, and as each traffic file says."""
import numpy as np
import pytest

from bench import cells, traffic

SEED = 2 ** 31 + 7


def _cells(bench):
    """Every cell of BENCHMARK.json, and a tiny one with bursts on shared
    prefixes, the generator's other mix."""
    from conftest import tiny_conf, tiny_mix
    return [cells.load(w["name"], bench) for w in bench["workloads"]] \
        + [cells.Cell("tiny.dense.agent", 1, tiny_conf(),
                      tiny_mix("agent"), [], [])]


def test_same_seed_same_requests(bench_json):
    for cell in _cells(bench_json):
        v = cell.conf["vocab_size"]
        a = traffic.generate(cell.mix, v, SEED, 12.0)
        b = traffic.generate(cell.mix, v, SEED, 12.0)
        assert [(x.rid, x.max_new_tokens, x.due_s, x.prefix) for x in a] \
            == [(x.rid, x.max_new_tokens, x.due_s, x.prefix) for x in b]
        assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_every_seed_offers_the_same_work(bench_json):
    for cell in _cells(bench_json):
        v = cell.conf["vocab_size"]
        a = traffic.generate(cell.mix, v, SEED, 12.0)
        b = traffic.generate(cell.mix, v, SEED + 1, 12.0)
        # the same schedule, the same lengths within each run of SHUFFLE
        assert [x.due_s for x in a] == [x.due_s for x in b]
        la = [x.max_new_tokens for x in a]
        lb = [x.max_new_tokens for x in b]
        k = traffic.SHUFFLE
        for i in range(0, len(la), k):
            assert sorted(la[i:i + k]) == sorted(lb[i:i + k])
        assert la != lb
        assert not np.array_equal(a[0].prompt, b[0].prompt)
        p = cell.mix["prompt"].get("prefixes", 0)
        if p:
            pa, pb = [x.prefix for x in a], [x.prefix for x in b]
            burst = cell.mix["arrivals"]["burst"]
            for i in range(0, len(pa), p * burst):
                assert sorted(pa[i:i + p * burst]) \
                    == sorted(pb[i:i + p * burst])
            assert pa != pb


@pytest.mark.parametrize("seconds", [5.0, 30.0])
def test_requests_match_the_traffic_file(bench_json, seconds):
    for cell in _cells(bench_json):
        mix, v = cell.mix, cell.conf["vocab_size"]
        reqs = traffic.generate(mix, v, SEED, seconds)
        arr, out, p = mix["arrivals"], mix["output"], mix["prompt"]
        burst = arr.get("burst", 1) if arr["kind"] == "bursts" else 1
        assert len(reqs) == round(arr["rate"] * seconds) * burst
        assert max(r.due_s for r in reqs) == pytest.approx(seconds)
        assert all(r.due_s > 0 for r in reqs)
        assert [r.due_s for r in reqs] == sorted(r.due_s for r in reqs)
        lens = np.array([r.max_new_tokens for r in reqs])
        assert lens.min() >= out["min"] and lens.max() <= out["max"]
        if len(lens) >= 100:
            assert abs(np.median(lens) - out["median"]) \
                <= 0.25 * out["median"]
        for r in reqs:
            assert r.prompt.dtype == np.int32
            assert len(r.prompt) == traffic.prompt_tokens(p)
            assert traffic.WARM_IDS <= r.prompt[0] < v
            assert r.prompt.min() >= 0 and r.prompt.max() < v
        if p["kind"] == "shared_prefix":
            n = p["prefix_tokens"]
            by = {}
            for r in reqs:
                by.setdefault(r.prefix, set()).add(r.prompt[:n].tobytes())
                assert n % mix["handler"]["block_size"] == 0
            assert sorted(by) == list(range(p["prefixes"]))
            assert all(len(s) == 1 for s in by.values())
            firsts = {r.prefix: int(r.prompt[0]) for r in reqs}
            assert len(set(firsts.values())) == p["prefixes"]
            for u in range(0, len(reqs), burst):
                group = reqs[u:u + burst]
                assert len({r.due_s for r in group}) == 1
                assert len({r.prefix for r in group}) == 1


def test_warmup_makes_each_shape_apart(bench_json):
    for cell in _cells(bench_json):
        mix, v = cell.mix, cell.conf["vocab_size"]
        wu = traffic.warmup(mix, v)
        assert all(np.array_equal(a.prompt, b.prompt) and a.due_s == b.due_s
                   for a, b in zip(wu, traffic.warmup(mix, v)))
        groups = {}
        for r in wu:
            groups.setdefault(r.due_s, []).append(r)
        sizes = [len(g) for _, g in sorted(groups.items())]
        want = list(mix["warmup"]["join_rows"])
        if mix["prompt"]["kind"] == "shared_prefix":
            want += [1] + list(mix["warmup"]["suffix_rows"])
        assert sizes == want
        firsts = [int(r.prompt[0]) for r in wu]
        assert max(firsts) < traffic.WARM_IDS
        fresh = [r for r in wu if r.prefix < 0]
        assert len({int(r.prompt[0]) for r in fresh}) == len(fresh)
