"""The port's device reductions of a validation sweep
(training/device_confusion.py, ops/confusion.py, ops/instance.py) and its
fused cleanup (PatchPredict's device_postprocess, ms_inference
--device-postprocess) on the CPU, against the JAX package and against the
port's host chain, on data made from a seed with numpy: every count and
label exactly.

The sweep fixture is dmri_hippo's hard case: the right-hemisphere label
collapses onto the left's under a masked remap (CustomRemapLabels(
masking_method='Right')), whose inversion depends on the position."""
import json

import numpy as np
import pytest
import torch

import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.msseg2.competition import ms_inference as jms_inference
from segmentation_pipeline_tpu.training import device_confusion as jdc
from segmentation_pipeline_torch import post_processing as tpp
from segmentation_pipeline_torch.evaluators.instance_segmentation_evaluator import (
    DEVICE_INSTANCE_KEY)
from segmentation_pipeline_torch.evaluators.segmentation_evaluator import DEVICE_CONFUSION_KEY
from segmentation_pipeline_torch.research.msseg2.competition import ms_inference as tms_inference
from segmentation_pipeline_torch.training import device_confusion as tdc

torch.set_num_threads(2)

SHAPE = (16, 16, 8)
LABELS = {"left_fg": 1, "right_fg": 2}


def write_dataset(root, n=6):
    rng = np.random.default_rng(0)
    for i in range(n):
        d = root / "subjects" / f"s{i}"
        d.mkdir(parents=True)
        img = rng.normal(scale=0.3, size=(1, *SHAPE)).astype(np.float32)
        seg = np.zeros((1, *SHAPE), np.int16)
        seg[:, 2:7, 4:12, 2:6] = 1
        seg[:, 9:14, 4:12, 2:6] = 2
        seg[:, 11:13, 1:3, 1:3] = 2  # a lesion of its own for the instance counts
        img[seg.astype(bool)] += 2.0
        tsp.write_nifti(d / "t1.nii.gz", img, np.eye(4))
        tsp.write_nifti(d / "seg.nii.gz", seg, np.eye(4))
        (d / "attributes.json").write_text(json.dumps({"fold": i % 2}))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("dev-conf")
    write_dataset(path)
    return path


def build_context(pkg, root, device_confusion, instance=False, extra_label_transform=None):
    on_cpu = {"device": "cpu"} if pkg is tsp else {}
    loader = pkg.ComposeLoaders([
        pkg.ImageLoader(glob_pattern="t1.*", image_name="t1", image_constructor=pkg.ScalarImage),
        pkg.ImageLoader(glob_pattern="seg.*", image_name="seg", image_constructor=pkg.LabelMap,
                        label_values=dict(LABELS)),
        pkg.AttributeLoader(glob_pattern="attributes.*"),
    ])
    steps = [
        pkg.CustomRemapLabels(remapping=[("right_fg", 2, 1)], masking_method="Right",
                              include=["seg"]),
        pkg.ConcatenateImages(image_names=["t1"], image_channels=[1], new_image_name="X"),
        pkg.RenameProperty(old_name="seg", new_name="y"),
        pkg.CustomOneHot(include=["y"]),
    ]
    if extra_label_transform is not None:
        steps.insert(1, extra_label_transform)
    evaluators = [pkg.ScheduledEvaluation(
        evaluator=pkg.SegmentationEvaluator("y_pred_eval", "y_eval"),
        log_name="seg", cohorts=["validation"], interval=2)]
    if instance:
        evaluators.append(pkg.ScheduledEvaluation(
            evaluator=pkg.InstanceSegmentationEvaluator("y_pred_eval", "y_eval"),
            log_name="inst", cohorts=["validation"], interval=2))
    ctx = pkg.Context("cpu", name="dev-conf", variables={"P": str(root)})
    ctx.add_component("dataset", pkg.SubjectFolder, root="$P", subject_path="subjects",
                      subject_loader=loader,
                      cohorts={"training": pkg.RequireAttributes(["t1"]),
                               "validation": pkg.RequireAttributes({"fold": 1})},
                      transforms={"default": pkg.Compose(steps)})
    ctx.add_component("model", pkg.NestedResUNet, input_channels=1, output_channels=2,
                      filters=4)
    ctx.add_component("optimizer", pkg.Adam, lr=3e-3)
    ctx.add_component("criterion", pkg.HybridLogisticDiceLoss)
    ctx.add_component(
        "trainer", pkg.SegmentationTrainer, training_batch_size=4, save_rate=100,
        scoring_interval=100, scoring_function=None, one_time_evaluators=[],
        training_evaluators=[], validation_evaluators=evaluators,
        max_iterations_with_no_improvement=100,
        train_predictor=pkg.StandardPredict(image_names=["X", "y"], **on_cpu),
        validation_predictor=pkg.StandardPredict(image_names=["X"], device_argmax=True,
                                                 **on_cpu),
        train_dataloader_factory=pkg.StandardDataLoader(sampler=pkg.RandomSampler),
        validation_dataloader_factory=pkg.StandardDataLoader(sampler=pkg.SequentialSampler),
        device_confusion=device_confusion)
    ctx.init_components()
    return ctx


class CaptureLogger(tsp.NonLogger):
    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append(record)


def sweep_stats(records):
    """{(iteration, log name): rows of subject stats}."""
    return {(r["iteration"], name): r[name]["validation"]["subject_stats"].records()
            for r in records for name in ("seg", "inst") if name in r}


def train(root, seed, iterations, **kwargs):
    tsp.seed_all(seed)
    ctx = build_context(tsp, root, **kwargs)
    logger = CaptureLogger()
    ctx.trainer.train(ctx, max_iterations=iterations, logger=logger)
    return ctx, sweep_stats(logger.records)


def same_rows(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for key in ra:
            assert ra[key] == rb[key] or (ra[key] != ra[key] and rb[key] != rb[key]), \
                (key, ra[key], rb[key])


@pytest.mark.parametrize("instance", [False, True], ids=["confusion", "confusion+instance"])
def test_sweeps_reduced_on_the_device_equal_the_host_path(root, capfd, instance):
    """Same seeds, device_confusion on and off: iteration 0 is the probe
    sweep (both paths ran), 2 and 4 are served by device counts alone; every
    subject's stats equal the host path's exactly, and the manager went
    from probe to on."""
    ctx_on, on = train(root, 99, 6, device_confusion=None, instance=instance)
    ctx_off, off = train(root, 99, 6, device_confusion=False, instance=instance)
    names = ["seg", "inst"] if instance else ["seg"]
    assert sorted(on) == sorted(off) == sorted((i, n) for i in (0, 2, 4) for n in names)
    for key in on:
        same_rows(on[key], off[key])
    mgr = ctx_on.trainer._confusion_mgr
    assert mgr.state == "on" and ctx_off.trainer._confusion_mgr is None
    assert [s for _, s, _ in ctx_on.trainer.sweep_times] == ["probe", "on", "on"]
    assert [s for _, s, _ in ctx_off.trainer.sweep_times] == ["host"] * 3
    assert mgr.subjects_delivered == 9 and mgr.bytes_fetched > 0
    out = capfd.readouterr().out
    assert "validated: validation sweeps now reduce on device" in out


def _subjects(pkg, root):
    ctx = build_context(pkg, root, device_confusion=False)
    dataset = ctx.dataset.get_cohort_dataset("validation")
    return [dataset[i] for i in range(len(dataset))]


def test_manager_counts_equal_jax(root):
    """The port's manager and JAX's, on the same transformed subjects and the
    same argmax channel ids: each subject's joint histogram and instance
    overlap entry equal exactly, through the masked remap's channel maps."""
    jsubjects, tsubjects = _subjects(jsp, root), _subjects(tsp, root)
    rng = np.random.default_rng(3)
    spec = {"confusion": True, "instance_connectivity": 2}
    jmgr = jdc.DeviceConfusionManager(dict(jsubjects[0]["y"].metadata))
    tmgr = tdc.DeviceConfusionManager(dict(tsubjects[0]["y"].metadata))
    for mgr in (jmgr, tmgr):
        mgr.configure_sweep(spec)
    jpairs, tpairs = [], []
    for js, ts in zip(jsubjects, tsubjects):
        ids = (rng.random(SHAPE) < 0.3).astype(np.uint8)
        jpairs.append((js, jmgr.device_joint(js, ids, 2)))
        tpairs.append((ts, tmgr.device_joint(ts, torch.from_numpy(ids), 2)))
    assert all(rec is not None for _, rec in tpairs)
    assert len(tmgr.deliver(tpairs)) == len(jmgr.deliver(jpairs)) == len(tsubjects)
    for js, ts in zip(jsubjects, tsubjects):
        jentry = js[jdc.CONFUSION_KEY][("y_pred_eval", "y_eval")]
        tentry = ts[DEVICE_CONFUSION_KEY][("y_pred_eval", "y_eval")]
        np.testing.assert_array_equal(tentry["joint"], np.asarray(jentry["joint"]))
        assert tentry["label_values"] == jentry["label_values"]
        jinst = js[jdc.INSTANCE_KEY][("y_pred_eval", "y_eval", 2)]
        tinst = ts[DEVICE_INSTANCE_KEY][("y_pred_eval", "y_eval", 2)]
        assert (tinst["n_target"], tinst["n_pred"]) == (jinst["n_target"], jinst["n_pred"])
        np.testing.assert_array_equal(tinst["hist"], jinst["hist"])
    assert tmgr.bytes_fetched == len(tsubjects) * 4 * (9 + 256 * 256 + 2 * 256)


def test_sweep_spec_matches_jax():
    def cases(pkg):
        seg = pkg.ScheduledEvaluation(pkg.SegmentationEvaluator("y_pred_eval", "y_eval"), "s",
                                      cohorts=["v"])
        inst = pkg.ScheduledEvaluation(pkg.InstanceSegmentationEvaluator(
            "y_pred_eval", "y_eval", connectivity=3), "i", cohorts=["v"])
        inst1 = pkg.ScheduledEvaluation(pkg.InstanceSegmentationEvaluator(
            "y_pred_eval", "y_eval", connectivity=1), "i1", cohorts=["v"])
        other = pkg.ScheduledEvaluation(pkg.LabelMapEvaluator("y_eval"), "l", cohorts=["v"])
        wrong = pkg.ScheduledEvaluation(pkg.SegmentationEvaluator("y_pred", "y"), "w",
                                        cohorts=["v"])
        on_cpu = {"device": "cpu"} if pkg is tsp else {}
        argmax = pkg.StandardPredict(device_argmax=True, **on_cpu)
        plain = pkg.StandardPredict(**on_cpu)
        return [([seg], argmax), ([seg, inst], argmax), ([inst], argmax), ([inst, inst1], argmax),
                ([seg, other], argmax), ([wrong], argmax), ([seg], plain), ([], argmax)]

    got = [tdc.sweep_spec(*c) for c in cases(tsp)]
    assert got == [jdc.sweep_spec(*c) for c in cases(jsp)]
    assert got[1] == {"confusion": True, "instance_connectivity": 3}
    assert [tdc.eligible_sweep(*c) for c in cases(tsp)] == [g is not None for g in got]


class RollLabels(tsp.transforms.base.LabelTransform):
    """Forward the identity; the inverse rolls the labels one voxel along W,
    so each output voxel reads its neighbour."""

    def apply_transform(self, subject):
        return None

    def is_invertible(self):
        return True

    def inverse(self, args=None):
        outer = self

        class Inverse(tsp.transforms.base.LabelTransform):
            def apply_transform(self, subject):
                for image in outer.get_images(subject):
                    data = np.asarray(image.data)
                    if data.shape[0] == 1:
                        image.set_data(np.roll(data, 1, axis=1))
                return None

        inverse = Inverse()
        inverse.include, inverse.exclude = outer.include, outer.exclude
        return inverse


def test_inverse_the_probe_cannot_represent_turns_the_manager_off(root, capfd):
    """The channel probe sees a roll of the labels as the identity: the probe
    sweep's exact comparison with the host chain catches it, the manager
    goes off and strips the entries, so the evaluators count on the host."""
    from segmentation_pipeline_torch.prediction import (_attach_prediction,
                                                        add_evaluation_labels, ids_to_onehot)

    ctx = build_context(tsp, root, device_confusion=False,
                        extra_label_transform=RollLabels(include=["seg"]))
    dataset = ctx.dataset.get_cohort_dataset("validation")
    subjects = [dataset[i] for i in range(len(dataset))]
    mgr = tdc.DeviceConfusionManager(dict(subjects[0]["y"].metadata))
    rng = np.random.default_rng(8)
    pairs = []
    for s in subjects:
        ids = (rng.random(SHAPE) < 0.4).astype(np.uint8)
        pairs.append((s, mgr.device_joint(s, torch.from_numpy(ids), 2)))
        _attach_prediction(s, ids_to_onehot(ids, 2), dict(s["y"].metadata))
    assert len(mgr.deliver(pairs)) == len(subjects)
    add_evaluation_labels(subjects)
    mgr.validate_probe(subjects)
    assert mgr.state == "off" and "device confusion mismatch" in capfd.readouterr().out
    assert not any(DEVICE_CONFUSION_KEY in s for s in subjects)
    assert mgr.device_joint(subjects[0], torch.zeros(SHAPE, dtype=torch.uint8), 2) is None


def test_validated_standard_predict_attaches_counts_only(root):
    subjects = _subjects(tsp, root)
    mgr = tdc.DeviceConfusionManager({"label_values": dict(LABELS)})
    mgr.state = "on"
    predictor = tsp.StandardPredict(image_names=["X"], device_argmax=True, device="cpu")
    predictor._confusion_plan = mgr
    model = tsp.SegModel(tsp.NestedResUNet(1, 2, filters=4), device="cpu")
    out, _ = predictor.predict(model, subjects, label_attributes={"label_values": dict(LABELS)})
    for s in out:
        assert "y_pred" not in s
        assert s[DEVICE_CONFUSION_KEY][("y_pred_eval", "y_eval")]["joint"].sum() == \
            np.prod(SHAPE)
    stats = tsp.SegmentationEvaluator("y_pred_eval", "y_eval")(out)["subject_stats"]
    assert len(stats) == 2 * len(out)


# ---- the fused cleanup ------------------------------------------------------

def lesion_model(pkg):
    """A model both packages run exactly: channel 1 is 1 where the first
    input channel exceeds 0.5, channel 0 its complement (channel-first)."""
    if pkg is tsp:
        def model(x):
            fg = (x[:, :1] > 0.5).float()
            return torch.cat([1 - fg, fg], dim=1)
    else:
        import jax.numpy as jnp

        def model(x):
            fg = (x[:, :1] > 0.5).astype(jnp.float32)
            return jnp.concatenate([1 - fg, fg], axis=1)
    return model


def lesion_volume(seed, shape):
    """An input whose thresholded mask has holes and specks: blobs with
    one-voxel holes punched in and isolated voxels around."""
    rng = np.random.default_rng(seed)
    x = np.zeros(shape, np.float32)
    for _ in range(4):
        c = [int(rng.integers(3, s - 3)) for s in shape]
        x[c[0] - 3:c[0] + 3, c[1] - 3:c[1] + 3, c[2] - 3:c[2] + 3] = 1.0
    x[rng.random(shape) < 0.02] = 0.0
    x[rng.random(shape) < 0.005] = 1.0
    return np.stack([x, rng.random(shape).astype(np.float32)])


def _patch_subjects(pkg, shapes, seed=0):
    out = []
    for i, shape in enumerate(shapes):
        s = pkg.Subject(name=f"s{i}")
        s["X"] = pkg.ScalarImage(tensor=lesion_volume(seed + i, shape), affine=np.eye(4))
        out.append(s)
    return out


@pytest.mark.parametrize("shapes", [[(20, 18, 14)], [(13, 11, 9), (20, 12, 10)]],
                         ids=["one", "padded_ragged"])
def test_patch_predict_fused_cleanup_equals_jax_and_the_host_chain(shapes):
    chain = tms_inference.CLEANUP_CHAIN
    kwargs = dict(patch_size=16, patch_overlap=4, padding_mode="edge", device_argmax=True,
                  device_postprocess=chain)
    tout, tbatch = tsp.PatchPredict(device="cpu", **kwargs).predict(
        lesion_model(tsp), _patch_subjects(tsp, shapes))
    jout, _ = jsp.PatchPredict(**kwargs).predict(lesion_model(jsp), _patch_subjects(jsp, shapes))
    plain, _ = tsp.PatchPredict(device="cpu", **{**kwargs, "device_postprocess": None}).predict(
        lesion_model(tsp), _patch_subjects(tsp, shapes))
    for ts, js, ps in zip(tout, jout, plain):
        np.testing.assert_array_equal(ts["y_pred"].data, js["y_pred"].data)
        host = np.argmax(ps["y_pred"].data, axis=0).astype(np.int32)
        for op, arg in chain:
            host, _ = getattr(tpp, op)(host, arg)
        np.testing.assert_array_equal(np.argmax(ts["y_pred"].data, axis=0), host)
        assert not np.array_equal(host, np.argmax(ps["y_pred"].data, axis=0))  # it cleaned


def test_requested_cleanup_is_never_skipped():
    subjects = _patch_subjects(tsp, [(16, 16, 16)])
    with pytest.raises(ValueError, match="requires device_argmax"):
        tsp.PatchPredict(patch_size=16, device_postprocess=[("remove_holes", 64)],
                         device="cpu").predict(lesion_model(tsp), subjects)
    with pytest.raises(ValueError, match="out_channels=1"):
        tsp.PatchPredict(patch_size=16, device_argmax=True,
                         device_postprocess=[("remove_holes", 64)], device="cpu").predict(
            lambda x: x[:, :1], subjects)


class _Dataset:
    """What ms_inference's inference() reads: transformed subjects by index
    and the raw ones."""

    def __init__(self, pkg, raws, transform):
        self.subjects = raws
        self._pkg, self._transform = pkg, transform

    def __len__(self):
        return len(self.subjects)

    def __getitem__(self, i):
        import copy

        return self._transform(copy.deepcopy(self.subjects[i]))


def _ms_dataset(pkg, tmp_path, geometric):
    raws = []
    for i in range(2):
        s = pkg.Subject(name=f"ms{i}", folder=str(tmp_path / f"ms{i}"))
        x = lesion_volume(10 + i, (20, 18, 14))
        s["flair_time01"] = pkg.ScalarImage(tensor=x[1:], affine=np.eye(4))
        s["flair_time02"] = pkg.ScalarImage(tensor=x[:1], affine=np.eye(4))
        raws.append(s)
    steps = [pkg.ConcatenateImages(image_names=["flair_time02", "flair_time01"],
                                   image_channels=[1, 1], new_image_name="X")]
    if geometric:
        steps.insert(0, pkg.CropOrPad((18, 18, 14)))
    return _Dataset(pkg, raws, pkg.Compose(steps))


@pytest.mark.parametrize("geometric", [False, True], ids=["fused", "host_fallback"])
def test_ms_inference_device_postprocess_equals_jax(tmp_path, capsys, monkeypatch, geometric):
    """ms_inference's inference() with device_postprocess in both packages on
    the same subjects: a tape of ConcatenateImages alone takes the fused path
    and a crop the host cleanup, per subject, and the masks on the raw grid
    equal JAX's."""
    monkeypatch.setattr(tms_inference, "PATCH_SIZE", 16)
    paths = tms_inference.inference(_ms_dataset(tsp, tmp_path / "t", geometric),
                                    lesion_model(tsp), "", "mask.nii.gz",
                                    device_postprocess=True, device="cpu")
    assert paths == [(f"ms{i}", "host" if geometric else "fused") for i in range(2)]
    printed = capsys.readouterr().out
    assert ("falling back to the host cleanup" in printed) == geometric
    monkeypatch.setattr(jsp.PatchPredict, "__init__", _patch16(jsp.PatchPredict.__init__))
    jms_inference.inference(_ms_dataset(jsp, tmp_path / "j", geometric), lesion_model(jsp), "",
                            "mask.nii.gz", device_argmax=True, device_postprocess=True)
    for i in range(2):
        port, _ = tsp.read_nifti(tmp_path / "t" / f"ms{i}" / "mask.nii.gz")
        ref, _ = tsp.read_nifti(tmp_path / "j" / f"ms{i}" / "mask.nii.gz")
        assert port.shape == (1, 20, 18, 14) and port.any()
        np.testing.assert_array_equal(port, ref)


def _patch16(init):
    def patched(self, *args, **kwargs):
        kwargs.update(patch_size=16, patch_overlap=8)
        init(self, *args, **kwargs)
    return patched
