"""The readers of the program's spans (``benchmark/spans.py`` and the
metrics that use it) on made-up Chrome traces whose numbers are worked
out by hand: busy time by the span over each activity's launch (on any
thread; the innermost span for a span's own time), a launch the trace
lacks filled in from the neighbours on the stream or left unattributed,
and idle stretches by their midpoint."""

import json
import types

import pytest

from benchmark import harness, spans
from benchmark.counts import affine_bound_s, words_bound_s

MAIN, AUTOGRAD, HOST, DEVICE = 1, 2, 100, 0

# (name, start us, end us, thread) of each host range of the train trace.
TRAIN_SPANS = [
    ("benchmark.traced_window", 0, 1000, MAIN),
    ("eegan.train.step", 10, 900, MAIN),
    ("eegan.train.text", 20, 95, MAIN),
    ("eegan.train.generator", 105, 200, MAIN),
    ("eegan.ops.affine_mask_relu.fwd", 150, 160, MAIN),
    ("eegan.train.d_hinge.0", 210, 398, MAIN),
    ("eegan.train.update", 405, 450, MAIN),
    ("eegan.train.d_magp.0", 452, 600, MAIN),
    ("eegan.train.update", 605, 650, MAIN),
    ("eegan.train.g_loss", 655, 848, MAIN),
    ("eegan.ops.words_similarity.fwd", 660, 680, MAIN),
    # The backward's kernel is launched from autograd's thread while the
    # main thread waits in backward() inside train.g_loss.
    ("eegan.ops.words_similarity.bwd_dr", 750, 770, AUTOGRAD),
    ("eegan.train.update", 855, 890, MAIN),
]
# (launch us or None, start us, end us, stream, launching thread) of each
# device activity; None: the trace holds no launch for it.
TRAIN_ACTS = [
    (30, 30, 90, 7, MAIN),  # text
    (110, 110, 140, 7, MAIN),  # generator
    (155, 155, 165, 7, MAIN),  # kernel 1, inside the generator
    (190, 190, 230, 7, MAIN),  # generator, running into the D phase
    (220, 240, 300, 7, MAIN),  # d_hinge
    (None, 300, 320, 7, MAIN),  # no launch: both neighbours d_hinge
    (330, 330, 380, 7, MAIN),  # d_hinge
    (420, 420, 440, 7, MAIN),  # update
    (470, 470, 560, 7, MAIN),  # d_magp
    (480, 500, 520, 8, MAIN),  # d_magp, on a second stream
    (620, 620, 630, 7, MAIN),  # update
    (665, 665, 675, 7, MAIN),  # kernel 3
    (700, 700, 740, 7, MAIN),  # g_loss
    (755, 755, 765, 7, AUTOGRAD),  # kernel 4
    (None, 765, 768, 7, MAIN),  # no launch: bwd_dr before, g_loss after
    (800, 800, 840, 7, MAIN),  # g_loss
    (860, 860, 880, 7, MAIN),  # update
    (950, 950, 960, 7, MAIN),  # the request loop's, outside every span
]
# Busy 523 us in all. Idle stretches (midpoint): 0-30 (15, no phase),
# 90-110 (100, none), 140-155 and 165-190 (generator), 230-240 and
# 320-330 (d_hinge), 380-420 (400, none), 440-470 and 560-620 (d_magp),
# 630-665 (update), 675-700, 740-755 and 768-800 (g_loss), 840-860 (850,
# none), 880-950 and 960-1000 (outside the step).
DAMSM = [dict(Bi=32, Bt=32, S=289, L=20, D=256, valid_words=400)]
AFFINE = dict(B=128, ngf=32, elem=2)


def chrome(host, acts, with_spans=True):
    """A Chrome trace as torch.profiler exports it: host ranges, runtime
    calls carrying ``correlation``, device activities carrying it."""
    events = [{"ph": "M", "name": "process_name", "pid": HOST, "tid": 0,
               "args": {"name": "python"}}]
    for name, s, e, tid in host:
        if with_spans or not name.startswith(spans.PREFIX):
            events.append({"ph": "X", "cat": "user_annotation", "name": name,
                           "pid": HOST, "tid": tid, "ts": s, "dur": e - s})
    events.append({"ph": "X", "cat": "gpu_user_annotation",
                   "name": "benchmark.traced_window", "pid": DEVICE,
                   "tid": 7, "ts": 0, "dur": 1000})
    for k, (launch, s, e, stream, tid) in enumerate(acts):
        corr = 1000 + k
        if launch is not None:
            events.append({"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "pid": HOST,
                           "tid": tid, "ts": launch, "dur": 2,
                           "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel" if k % 5 else "gpu_memcpy",
                       "name": f"k{k}", "pid": DEVICE, "tid": stream,
                       "ts": s, "dur": e - s,
                       "args": {"correlation": corr, "stream": stream}})
    return {"traceEvents": events}


def write_run(tmp_path, monkeypatch, cell_name, trace, seed=2 ** 33 + 5):
    """The trace where the run of ``cell_name`` at ``seed`` writes it, and
    this process's arguments as that run's."""
    out = tmp_path / "benchmark_out"
    out.mkdir(exist_ok=True)
    if trace is not None:
        (out / f"{cell_name}-{seed}.trace.json").write_text(json.dumps(trace))
    monkeypatch.setattr("sys.argv", [
        "run.py", "--workload", cell_name, "--seed", str(seed),
        "--seconds", "51", "--trace", "1"])
    return types.SimpleNamespace(root=tmp_path, name=cell_name)


def train_obs(cell):
    return {"kind": "train", "cell": cell, "trace": object(),
            "traced_steps": 1, "damsm": DAMSM}


def read(name, obs):
    return harness.metric_reader(name)(obs)


def test_train_readers(tmp_path, monkeypatch):
    cell = write_run(tmp_path, monkeypatch, "bird-train-b32",
                     chrome(TRAIN_SPANS, TRAIN_ACTS))
    obs = train_obs(cell)
    # D phase: 240-320 (the launchless one from its neighbours), 330-380,
    # 470-560 (500-520 on the second stream inside it).
    assert read("d_phase_busy_ms_per_step.train", obs) == pytest.approx(0.220)
    assert read("d_phase_idle_ms_per_step.train", obs) == pytest.approx(
        1e-3 * (10 + 10 + 30 + 60))
    # G phase: text, generator (kernel 1 and the one that runs into the D
    # phase's time with it), g_loss with kernels 3 and 4.
    assert read("g_phase_busy_ms_per_step.train", obs) == pytest.approx(
        1e-3 * (60 + 30 + 10 + 40 + 10 + 40 + 10 + 40))
    assert read("g_phase_idle_ms_per_step.train", obs) == pytest.approx(
        1e-3 * (15 + 25 + 25 + 15 + 32))
    assert read("update_idle_ms_per_step.train", obs) == pytest.approx(
        0.035)
    assert read("words_similarity_roofline.train", obs) == pytest.approx(
        100 * words_bound_s(**DAMSM[0]) / 20e-6)
    obs["traced_steps"] = 4
    assert read("d_phase_busy_ms_per_step.train", obs) == pytest.approx(
        0.055)


def test_innermost_span_and_the_launchless(tmp_path):
    s = spans.from_events(chrome(TRAIN_SPANS, TRAIN_ACTS)["traceEvents"])
    assert s.total_busy_s == pytest.approx(523e-6)
    assert sum(e - b for b, e in s.idle) == pytest.approx(477e-6)
    own = {k: v["own_busy_s"] for k, v in s.by_span().items()}
    assert own["ops.words_similarity.fwd"] == pytest.approx(10e-6)
    assert own["ops.words_similarity.bwd_dr"] == pytest.approx(10e-6)
    assert own["train.g_loss"] == pytest.approx(80e-6)
    assert own["train.generator"] == pytest.approx(70e-6)
    assert own["ops.affine_mask_relu.fwd"] == pytest.approx(10e-6)
    assert own["train.step"] == 0
    names = [s.names[i] if i >= 0 else i for i in s.inner]
    assert names[5] == "train.d_hinge.0"
    assert names[14] == spans.UNATTRIBUTED
    assert names[17] == spans.OUTSIDE
    assert s.share(spans.UNATTRIBUTED) == pytest.approx(100 * 3 / 523)
    assert s.share(spans.OUTSIDE) == pytest.approx(100 * 10 / 523)
    # Idle by midpoint: the stretch between two phases goes to neither.
    assert s.idle_s(["train.step"]) == pytest.approx(
        1e-6 * (477 - 70 - 40))
    assert s.idle_s(["train.d_hinge"]) == pytest.approx(20e-6)


def test_generate_readers(tmp_path, monkeypatch):
    host = [("benchmark.traced_window", 0, 1000, MAIN),
            ("eegan.sample.step", 10, 80, MAIN),
            ("eegan.sample.text", 15, 30, MAIN),
            ("eegan.sample.generator", 35, 75, MAIN),
            ("eegan.ops.affine_mask_relu.fwd", 40, 45, MAIN)]
    acts = [(16, 16, 28, 7, MAIN), (41, 41, 44, 7, MAIN),
            (50, 50, 70, 7, MAIN), (85, 85, 995, 7, MAIN)]
    cell = write_run(tmp_path, monkeypatch, "bird-generate-b128",
                     chrome(host, acts))
    obs = {"kind": "generate", "cell": cell, "trace": object(),
           "traced_requests": 2, "affine": AFFINE}
    # Idle 28-41, 44-50 and 70-85 (midpoint 77.5) inside sample.step;
    # 0-16 and 995-1000 are the request loop's.
    assert read("sample_idle_ms_per_request.generate", obs) == \
        pytest.approx(1e-3 * (13 + 6 + 15) / 2)
    assert read("affine_mask_relu_roofline.generate", obs) == \
        pytest.approx(100 * 2 * affine_bound_s(**AFFINE) / 3e-6)
    assert read("d_phase_busy_ms_per_step.train", obs) is None


NEW = ("d_phase_busy_ms_per_step.train", "d_phase_idle_ms_per_step.train",
       "g_phase_busy_ms_per_step.train", "g_phase_idle_ms_per_step.train",
       "update_idle_ms_per_step.train", "words_similarity_roofline.train",
       "affine_mask_relu_roofline.generate",
       "sample_idle_ms_per_request.generate")


@pytest.mark.parametrize("trace", ["missing", "no spans"])
def test_nothing_to_read(tmp_path, monkeypatch, trace):
    train = chrome(TRAIN_SPANS, TRAIN_ACTS, with_spans=False)
    for name in ("bird-train-b32", "bird-generate-b128"):
        cell = write_run(tmp_path, monkeypatch, name,
                         None if trace == "missing" else train)
        obs = dict(train_obs(cell), traced_requests=1, affine=AFFINE)
        for metric in NEW:
            obs["kind"] = metric.rsplit(".", 1)[1]
            assert read(metric, obs) is None, metric
    assert spans.of_run({"kind": "train"}, "train") is None


def test_every_new_metric_has_its_reader_and_cells():
    spec = harness.benchmark_spec()
    cells = {w["name"] for w in spec["workloads"]}
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] == "device_trace"
        assert m["workloads"] and set(m["workloads"]) <= cells
        assert (harness.HERE / "metrics" / f"{name}.py").is_file()
        assert harness.metric_reader(name)({}) is None
