"""``d_graph_share.train`` on made-up Chrome traces: 100 when every D
unit (hinge, MAGP and their two updates a scale) replays inside a
``train.d_graph`` span, the share that did when only some do, nothing
without the span."""

import pytest

from benchmark.tests.test_bench_spans import (
    MAIN,
    chrome,
    read,
    train_obs,
    write_run,
)

METRIC = "d_graph_share.train"


def d_phase(scales, graphed):
    """Host ranges of a step's D phase from 0 us: per scale the hinge,
    an update, the MAGP and an update; each unit whose index (0-3 per
    scale) is in ``graphed`` holds a ``train.d_graph`` span."""
    host = [("benchmark.traced_window", 0, 1000, MAIN),
            ("eegan.train.step", 1, 999, MAIN)]
    t = 10
    for i in range(scales):
        for u, name in enumerate((f"d_hinge.{i}", "update", f"d_magp.{i}",
                                  "update")):
            host.append((f"eegan.train.{name}", t, t + 20, MAIN))
            if u in graphed:
                host.append(("eegan.train.d_graph", t + 5, t + 15, MAIN))
            t += 25
    return host


ACTS = [(12, 12, 30, 7, MAIN), (40, 40, 60, 7, MAIN)]


@pytest.mark.parametrize("graphed, share", [
    ((0, 1, 2, 3), 100.0),
    ((0, 2), 50.0),
    ((1,), 25.0),
])
def test_share_of_the_units_that_replayed(tmp_path, monkeypatch, graphed,
                                          share):
    cell = write_run(tmp_path, monkeypatch, "bird-train-b32",
                     chrome(d_phase(3, graphed), ACTS))
    assert read(METRIC, train_obs(cell)) == pytest.approx(share)


@pytest.mark.parametrize("trace", ["no graph span", "no spans", "missing",
                                   "generate"])
def test_nothing_to_read(tmp_path, monkeypatch, trace):
    host = d_phase(3, () if trace == "no graph span" else (0, 1, 2, 3))
    cell = write_run(tmp_path, monkeypatch, "bird-train-b32",
                     None if trace == "missing" else
                     chrome(host, ACTS, with_spans=trace != "no spans"))
    obs = train_obs(cell)
    if trace == "generate":
        obs["kind"] = "generate"
    assert read(METRIC, obs) is None
