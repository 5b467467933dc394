"""The port's spans and counters (utils/timer.py) on the profiler's clock:
nothing recorded with the profiler off; parents, request ids and the wait
arithmetic with it on; every recorded span a ``user_annotation`` of the
same session's Chrome trace; the trainer's phases per iteration, the
predictors' requests and the library convs' count; and the benchmark's
readers of them on small CPU cells."""
import collections
import json
import math
import time

import numpy as np
import pytest
import torch

import segmentation_pipeline_torch as tsp
from h100_bench import data, harness
from h100_bench.tests.small import SMALL
from segmentation_pipeline_torch.utils import timer
from segmentation_pipeline_torch.utils.timer import Timer, count, host_ms, recorded, span

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh_records():
    timer.reset()
    yield
    timer.reset()


def by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


def test_nothing_recorded_with_the_profiler_off():
    with span("a", wait=True, k=1):
        with span("b"):
            count("c", "key")
    t = Timer()
    t.start()
    with t.phase("split", "d"):
        pass
    rec = recorded()
    assert rec["spans"] == [] and rec["counters"] == {} and rec["dropped"] == 0
    assert list(t.timestamps) == ["split"] and t.timestamps["split"] >= 0


def test_parents_requests_and_waits():
    profiler = torch.profiler.profile(activities=CPU)
    profiler.start()
    try:
        with span("root", iteration=3):
            with span("host"):
                with span("read", wait=True):
                    with span("inner", wait=True):
                        time.sleep(0.002)
                time.sleep(0.001)
            with span("fetch", wait=True):
                time.sleep(0.002)
            count("calls", ("a", 1))
            count("calls", ("a", 1), 2)
        with span("other"):
            pass
        late = span("late")
        late.__enter__()
    finally:
        profiler.stop()
    late.__exit__(None, None, None)  # entered while recording: closes normally
    with span("after"):  # the profiler is off again
        count("calls", ("a", 1))
    rec = recorded()
    spans = by_name(rec["spans"])
    assert sorted(spans) == ["fetch", "host", "inner", "late", "other", "read", "root"]
    root, host, read = spans["root"][0], spans["host"][0], spans["read"][0]
    inner, fetch, other = spans["inner"][0], spans["fetch"][0], spans["other"][0]
    assert root.parent is None and root.request == root.id and root.attrs == {"iteration": 3}
    assert (host.parent, read.parent, inner.parent, fetch.parent) == \
        (root.id, host.id, read.id, root.id)
    assert {s.request for s in (host, read, inner, fetch)} == {root.id}
    assert other.parent is None and other.request == other.id != root.id
    assert read.wait and inner.wait and fetch.wait and not host.wait
    assert all(s.end_ns >= s.start_ns for s in rec["spans"])
    assert rec["counters"] == {"calls": collections.Counter({("a", 1): 3})}
    # the outermost waits come off, once: the inner wait lies inside read
    all_spans = rec["spans"]
    assert host_ms(root, all_spans) == pytest.approx(root.ms - read.ms - fetch.ms, abs=1e-9)
    assert host_ms(host, all_spans) == pytest.approx(host.ms - read.ms, abs=1e-9)
    assert host_ms(host, all_spans) >= 1.0
    assert host_ms(other, all_spans) == pytest.approx(other.ms, abs=1e-9)
    timer.reset()
    assert recorded() == {"spans": [], "counters": {}, "dropped": 0}


def test_the_record_is_capped(monkeypatch):
    monkeypatch.setattr(timer, "MAX_SPANS", 3)
    with torch.profiler.profile(activities=CPU):
        for _ in range(5):
            with span("s"):
                pass
    rec = recorded()
    assert len(rec["spans"]) == 3 and rec["dropped"] == 2


def small_trainer(root):
    """dmri_hippo's ported configuration at test sizes, on the fast path,
    with every evaluation, checkpoint and score due every other
    iteration."""
    from segmentation_pipeline_torch.research.dmri_hippo.configs import main_config

    data.write_hippo_dataset(str(root), 5, [20, 18, 6],
                             {"validation": 2, "training": 4, "ab300": 2})
    context = main_config.get_context(device="cpu", variables={"DATASET_PATH": str(root)},
                                      training_batch_size=2, crop_shape=(16, 16, 8), filters=4,
                                      tpu_fast_path=True)
    params = context.get_component_definition("trainer")["params"]

    def keep(scheduled):  # the contour plots need matplotlib
        return [s for s in scheduled
                if not isinstance(s.evaluator, tsp.ContourImageEvaluator)]
    context.update_component("trainer", training_evaluators=keep(params["training_evaluators"]),
                             validation_evaluators=keep(params["validation_evaluators"]))
    context.init_components()
    trainer = context.trainer
    for scheduled in trainer.training_evaluators + trainer.validation_evaluators:
        scheduled.interval = 2
    trainer.save_rate = trainer.scoring_interval = 2
    return context


class Records(tsp.NonLogger):
    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append(record)


@pytest.fixture(scope="module")
def trainer_run(tmp_path_factory):
    """Three iterations under the profiler: the spans, the log records and
    the session's Chrome trace."""
    torch.set_num_threads(2)
    context = small_trainer(tmp_path_factory.mktemp("hippo"))
    logger = Records()
    timer.reset()
    with torch.profiler.profile(activities=CPU) as profiler:
        context.trainer.train(context, max_iterations=3, validation_batch_size=4,
                              logger=logger)
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    profiler.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    rec = recorded()
    timer.reset()
    return rec, logger.records, events


# the children of each iteration: always, on busy iterations (everything
# due, the loss read on the spot) and on the logging-only one (its read
# deferred to the next iteration)
EVERY = {"trainer.fetch", "trainer.augment", "trainer.step"}
BUSY = EVERY | {"trainer.read_loss", "trainer.train_eval", "trainer.sweep", "trainer.val_eval",
                "trainer.checkpoint", "trainer.log"}


def test_trainer_records_its_phases_per_iteration(trainer_run):
    rec, records, _ = trainer_run
    spans = rec["spans"]
    iterations = by_name(spans)["trainer.iteration"]
    assert [s.attrs["iteration"] for s in iterations] == [0, 1, 2]
    children = {s.id: collections.Counter(c.name for c in spans if c.parent == s.id)
                for s in iterations}
    first, second, third = (children[s.id] for s in iterations)
    assert set(first) == BUSY | {"trainer.build_step"}
    assert set(second) == EVERY and set(third) == BUSY
    assert first["trainer.fetch"] == 2  # the first batch and the prefetch
    assert third["trainer.read_loss"] == 2  # iteration 1's deferred read, then its own
    assert third["trainer.log"] == 3  # iteration 1's record, the score, its own record
    named = by_name(spans)

    def kids(name):
        return {c.name for s in named[name] for c in spans if c.parent == s.id}
    assert kids("trainer.train_eval") == {"trainer.train_eval.read", "trainer.train_eval.attach",
                                          "trainer.train_eval.evaluate"}
    assert kids("trainer.sweep") == {"trainer.sweep.load", "predict", "predict.finish"}
    assert kids("trainer.val_eval") == {"trainer.val_eval.evaluate"}
    assert all(s.wait for s in named["augment.read"] + named["trainer.read_loss"]
               + named["trainer.train_eval.read"] + named["trainer.sweep.load"])
    assert all(s.request in {i.id for i in iterations} for s in spans)
    # the log's timer keys come from the spans of their phases
    assert [r["iteration"] for r in records] == [0, 1, 2]
    assert sorted(records[1]["timer"]) == ["data_loading", "next_batch_prefetch", "train_step"]
    assert {"data_loading", "next_batch_prefetch", "train_step", "model_forward_evaluation",
            "save_checkpoint"} <= set(records[0]["timer"])
    assert records[1]["timer"]["data_loading"] == 0.0


def test_every_span_is_an_annotation_of_the_trace(trainer_run):
    rec, _, events = trainer_run
    annotations = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            annotations[e["name"]].append(e)
    spans = rec["spans"]
    assert spans
    matched = {}
    for name, group in by_name(spans).items():
        marks = sorted(annotations[name], key=lambda e: float(e["ts"]))
        assert len(marks) == len(group), name
        for s, e in zip(sorted(group, key=lambda s: s.start_ns), marks):
            assert float(e["dur"]) / 1e3 == pytest.approx(s.ms, rel=0.02, abs=1.0), name
            matched[s.id] = e
    for s in spans:
        if s.parent is not None:
            e, p = matched[s.id], matched[s.parent]
            assert e["tid"] == p["tid"]
            assert float(p["ts"]) <= float(e["ts"])
            assert float(e["ts"]) + float(e["dur"]) <= float(p["ts"]) + float(p["dur"])


def patch_predict_pair():
    module = tsp.ModularUNet(2, 2, filters=[4, 4, 8], depth=3, block_params={"residual": True},
                             downsample_class=tsp.BlurConv3d,
                             downsample_params={"kernel_size": 3, "stride": 2, "padding": 1},
                             upsample_class=tsp.BlurConvTranspose3d,
                             upsample_params={"kernel_size": 3, "stride": 2, "padding": 1,
                                              "output_padding": 0})
    return module, tsp.SegModel(module, device="cpu")


@pytest.mark.parametrize("predictor", ["StandardPredict", "PatchPredict"])
def test_a_predict_call_records_its_four_children(predictor):
    rng = np.random.default_rng(0)
    subject = tsp.Subject(name="s")
    if predictor == "StandardPredict":
        model = tsp.SegModel(tsp.NestedResUNet(3, 2, filters=4), device="cpu")
        subject["X"] = tsp.ScalarImage(tensor=rng.standard_normal((3, 16, 16, 8)).astype(
            np.float32))
        p = tsp.StandardPredict(image_names=["X"], sagittal_split=True, device="cpu")
    else:
        _, model = patch_predict_pair()
        subject["X"] = tsp.ScalarImage(tensor=rng.standard_normal((2, 20, 18, 16)).astype(
            np.float32))
        p = tsp.PatchPredict(image_names=["X"], patch_batch_size=2, patch_size=16,
                             patch_overlap=8, padding_mode="edge", device="cpu")
    with torch.profiler.profile(activities=CPU):
        out, _ = p.predict(model, [subject])
    assert "y_pred" in out[0]
    spans = recorded()["spans"]
    roots = [s for s in spans if s.parent is None]
    assert [(s.name, s.attrs) for s in roots] == \
        [("predict", {"predictor": predictor, "subjects": 1})]
    kids = [s for s in spans if s.parent == roots[0].id]
    assert {s.name for s in kids} == {"predict.prepare", "predict.forward", "predict.read",
                                      "predict.finish"}
    assert [s.name for s in kids if s.wait] == ["predict.read"]
    assert host_ms(roots[0], spans) < roots[0].ms


@pytest.mark.parametrize("grad", [True, False], ids=["with_grad", "no_grad"])
def test_library_convs_counted_per_module(grad):
    module, _ = patch_predict_pair()
    downs = sum(isinstance(m, tsp.BlurConv3d) for m in module.modules())
    up_modules = [m for m in module.modules() if isinstance(m, tsp.BlurConvTranspose3d)]
    ups = len(up_modules)
    assert downs == ups == 2
    x = torch.randn(1, 16, 16, 16, 2, requires_grad=grad)
    with torch.profiler.profile(activities=CPU), torch.set_grad_enabled(grad):
        y = module(x)
        if grad:
            y.sum().backward()
    calls = recorded()["counters"]["library_conv"]
    kinds = collections.Counter()
    for (direction, kind, dtype, n, cin, cout, spatial, stride), c in calls.items():
        assert dtype == "float32" and n == 1 and stride == (2, 2, 2) and len(spatial) == 3
        kinds[direction, kind] += c
    if grad:
        assert kinds == {("forward", "conv"): downs, ("forward", "transposed"): ups,
                         ("backward", "conv"): downs, ("backward", "transposed"): ups}
    else:
        assert kinds == {("forward", "conv"): downs, ("forward", "by_phase"): ups}
    # the transposed convs keyed by the layer's channels (weight: Cout, Cin)
    ups_keys = [k for k in calls if k[1] != "conv" and k[0] == "forward"]
    assert sorted((k[4], k[5]) for k in ups_keys) == \
        sorted(tuple(m.weight.shape[1::-1]) for m in up_modules)
    assert sorted(k[6] for k in ups_keys) == [(4, 4, 4), (8, 8, 8)]


# the new readers of the program's spans and counters, by cell
READERS = {"hippo-train-f32": ("trainer_eval_ms.train", "trainer_dispatch_ms.train"),
           "msseg2-serve-f32": ("predict_host_ms.serve", "library_conv_launches.serve"),
           "hippo-tta-bf16": ("predict_host_ms.serve",)}


@pytest.mark.parametrize("workload", sorted(READERS))
def test_readers_on_a_small_cell(workload, tmp_path):
    overrides = {k: dict(v) for k, v in SMALL[workload].items()}
    if workload == "hippo-train-f32":
        # iterations 1-10: the Dice evaluation of iteration 10 inside
        overrides["traffic"].update(trace_from=1, trace_iterations=10)
    torch.set_num_threads(2)
    result = harness.run_cell(harness.load_spec(), workload, 2 ** 31 + 11, 0.2, True,
                              time.time(), device="cpu", overrides=overrides)
    for name in READERS[workload]:
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    if workload == "msseg2-serve-f32":
        # 4 library convs a window forward, 8 windows of 32^3 a subject at
        # the test sizes
        assert result["metrics"]["library_conv_launches.serve"]["value"] == 32
