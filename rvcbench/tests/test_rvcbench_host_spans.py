"""The readers of the program's host spans: a value from a made-up record
of `timing.read()`'s keys, None where the keys are missing (a program
without the spans), and each traced tiny cell on the CPU reading its two
metrics from the program's own spans."""

import pytest

from rvcbench import run
from rvcbench.lib import cells
from rvcbench.tests.tiny import tiny_cell, tiny_config, tiny_train

OFFLINE = {"audio_s": 20.0, "spans": {
    "host.load": 10.0, "host.split": 6.0, "host.upload": 4.0,
    "host.fetch": 30.0, "decoder": 45.0}}
SERVE = {"tick_ms": [100.0] * 4, "spans": {
    "host.tick": 400.0, "host.fetch": 120.0, "host.sola": 40.0,
    "f0": 90.0}}
TRAIN = {"steps": 5, "spans": {
    "host.load": 25.0, "host.collate": 300.0, "host.step": 1000.0,
    "g_step": 1400.0}}
WANT = [
    ("host_prep_ms_per_audio_s.offline", OFFLINE, 1.0),
    ("fetch_ms_per_audio_s.offline", OFFLINE, 1.5),
    ("sola_ms.serve", SERVE, 10.0),
    ("tick_host_ms.serve", SERVE, 70.0),
    ("collate_ms.train", TRAIN, 65.0),
    ("step_host_ms.train", TRAIN, 200.0),
]
NEW = {"offline": ("host_prep_ms_per_audio_s.offline",
                   "fetch_ms_per_audio_s.offline"),
       "serve": ("sola_ms.serve", "tick_host_ms.serve"),
       "train": ("collate_ms.train", "step_host_ms.train")}


@pytest.mark.parametrize("name,rec,want", WANT)
def test_reader_on_a_made_up_record(name, rec, want):
    assert cells.metric(name).read(rec) == pytest.approx(want)


@pytest.mark.parametrize("name,rec,_", WANT)
def test_reader_without_the_spans_reads_nothing(name, rec, _):
    """The parent program's spans carry no `host.` keys; a window with no
    work reads nothing either."""
    reader = cells.metric(name)
    old = {k: v for k, v in rec["spans"].items() if not k.startswith("host.")}
    assert reader.read({**rec, "spans": old}) is None
    assert reader.read({k: v for k, v in rec.items() if k != "spans"}) is None
    empty = {k: (0 if k == "steps" else [] if k == "tick_ms" else 0.0)
             for k in rec if k != "spans"}
    assert reader.read({**empty, "spans": rec["spans"]}) is None


def test_each_new_metric_is_listed_for_its_cell():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        entry = cells.traffic(w["traffic"])["entry"]
        traced = {m["name"] for m in cells.metrics_for(w["name"], True)}
        plain = {m["name"] for m in cells.metrics_for(w["name"], False)}
        for kind, names in NEW.items():
            assert (set(names) <= traced) == (kind == entry), w["name"]
            assert not set(names) & plain, w["name"]


@pytest.mark.parametrize("name", ["v2-48k.offline", "v2-40k.serve-n32",
                                  "v2-40k.train-b32"])
def test_a_traced_tiny_run_reads_its_host_spans(name, tmp_path):
    if name.endswith("train-b32"):
        cell, cfg = tiny_train(name)
    else:
        cell = tiny_cell(name)
        cfg = tiny_config(cell["config"])
    rec = run.run_cell(name, 2 ** 33 + 7, 1.0, True, "cpu", str(tmp_path),
                       cell=cell, cfg=cfg)["rec"]
    for metric in NEW[cell["entry"]]:
        assert cells.metric(metric).read(rec) > 0, metric
