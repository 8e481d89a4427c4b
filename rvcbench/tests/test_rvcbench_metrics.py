"""The metric arithmetic on made-up numbers, and discovery by name."""

import json

import pytest

from rvcbench.lib import cells, stats


def test_percentile_is_over_every_tick():
    ticks = [float(i) for i in range(1, 101)]            # 1..100 ms
    assert stats.percentile(ticks, 95) == pytest.approx(95.05)
    assert stats.percentile([7.0], 95) == 7.0
    # one slow tick among 100 moves the p95 only by its rank
    assert stats.percentile(ticks[:-1] + [1e4], 95) == pytest.approx(95.05)


def test_rate_is_work_over_the_whole_window():
    assert stats.rate(92.0, 0.8) == pytest.approx(115.0)
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_union_and_gaps_of_made_up_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (9.0, 12.0)]
    assert stats.union_seconds(iv) == pytest.approx(7.0)
    assert stats.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_idle_share_from_the_union():
    rec = {"cell": {"entry": "offline"},
           "trace": {"window_s": 10.0,
                     "busy_s": stats.union_seconds([(0, 4), (3, 7)])}}
    assert cells.metric("idle_pct.infer").read(rec) == pytest.approx(30.0)


def test_end_to_end_readers():
    rec = {"window_s": 10.0, "audio_s": 920.0, "setup_s": 12.5,
           "tick_ms": [100.0] * 95 + [200.0] * 5}
    assert cells.metric("audio_s_per_s").read(rec) == pytest.approx(92.0)
    assert cells.metric("setup_s").read(rec) == 12.5
    p95 = cells.metric("block_ms_p95").read(rec)
    assert p95 == pytest.approx(stats.percentile(rec["tick_ms"], 95))
    assert cells.metric("block_ms_p95").read({"window_s": 1.0}) is None


def test_readers_that_find_nothing_return_nothing():
    rec = {"window_s": 1.0, "cell": {"entry": "offline"}, "cfg": {}}
    for name in ("mfu_pct.infer", "k2_roofline_pct.infer", "idle_pct.infer",
                 "f0_ms.serve", "decoder_ms_per_audio_s.offline"):
        assert cells.metric(name).read(rec) is None, name


def test_k2_roofline_share():
    k2 = cells.metric("k2_roofline_pct.infer")
    model = cells.config("rvc-v2-48k")["model"]
    least = k2.least_seconds(model, 1598, 1)
    rec = {"cfg": {"model": model},
           "decoder_calls": [{"streams": 1, "frames": 1598, "calls": 2}],
           "trace": {"kernels": {"conv_kernel(float const*)": 4 * least,
                                 "banded_rel_attention_kernel": 1.0}}}
    assert k2.read(rec) == pytest.approx(50.0)
    # a 16 s bucket's four levels are bound by their work
    assert least == pytest.approx(sum(
        k2.stage_work(512 >> (i + 1), 1598 * t, (3, 7, 11))
        for i, t in enumerate((12, 120, 240, 480))) / 494.7e12)


def test_every_cell_metric_and_config_is_found_by_name():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        traffic = cells.traffic(w["traffic"])
        assert traffic["name"] == w["name"]
        assert traffic["config"] == w["config"]
        assert traffic["chips"] == w["chips"] and traffic["why"] == w["why"]
        cells.config(w["config"])
        cells.driver(traffic["entry"]).Driver
        reported = {m["name"] for m in cells.metrics_for(w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert cells.metrics_for(w["name"], True)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cells.metric(m["name"]).read)
    for c in bench["configs"]:
        assert json.loads(open(cells.ROOT.parent / c["file"]).read())[
            "name"] == c["name"]


def test_metrics_for_follows_the_benchmark_file():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "c", "workloads": ["y"]}]}
    assert [m["name"] for m in cells.metrics_for("x", False, bench)] == \
        ["a", "b"]
    assert [m["name"] for m in cells.metrics_for("y", False, bench)] == ["a"]
    assert [m["name"] for m in cells.metrics_for("y", True, bench)] == ["c"]
    with pytest.raises(KeyError):
        cells.traffic("no-such-cell")
