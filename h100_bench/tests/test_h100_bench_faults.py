"""The comparison that decides ``correct`` comes out false when the timed
path is broken underneath: the cells run at small sizes on the CPU (the
harness's look for a card skipped), with a fault planted in the program,
and are judged against the cells' own limits. The controls read above the
sound runs here too."""
import pytest
import torch

from h100_bench import harness
from h100_bench.tests.small import small_driver


def judged(workload, driver):
    return harness.judge(driver.check(), harness.load_limits(workload))


def test_sound_runs_are_far_from_their_limits(tmp_path):
    for workload in ("hippo-train-f32", "msseg2-serve-f32"):
        checks = small_driver(workload, 5, str(tmp_path)).check()
        limits = harness.load_limits(workload)
        assert all(checks[n] <= limits[n]["limit"] for n in limits), checks


def _step_fault(monkeypatch, fault):
    from segmentation_pipeline_torch.training import trainer

    original = trainer.make_train_step

    def make(*args, **kwargs):
        inner = original(*args, **kwargs)

        def step(state, batch, generator):
            if fault == "half_batch":  # rows of the second half replaced by the first's
                n = batch["X"].shape[0] // 2
                half = {k: torch.cat([v[:n], v[:n]]) for k, v in batch.items()}
                return inner(state, half, generator)
            before = {n: p.detach().clone() for n, p in state.params.items()}
            out = inner(state, batch, generator)
            with torch.no_grad():
                for n, p in state.params.items():
                    p.copy_(before[n])
            return out
        return step
    monkeypatch.setattr(trainer, "make_train_step", make)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_training_faults_fail(monkeypatch, tmp_path, fault):
    _step_fault(monkeypatch, fault)
    correct, table = judged("hippo-train-f32", small_driver("hippo-train-f32", 5, str(tmp_path)))
    assert not correct, table


def test_altered_patch_answer_fails(monkeypatch, tmp_path):
    from segmentation_pipeline_torch import prediction

    original = prediction.sliding_window_inference

    def altered(*args, **kwargs):
        out = original(*args, **kwargs).clone()
        out[:, 3, 3, 3] = out[:, 3, 3, 3].flip(0)
        return out
    monkeypatch.setattr(prediction, "sliding_window_inference", altered)
    correct, table = judged("msseg2-serve-f32", small_driver("msseg2-serve-f32", 5, str(tmp_path)))
    assert not correct, table


def test_altered_vote_fails(monkeypatch, tmp_path):
    import segmentation_pipeline_torch as tsp

    original = tsp.EnsembleModels.__call__

    def altered(self, x):
        out = original(self, x)
        out[:, :, :4, :4, :4] = out[:, :, :4, :4, :4].flip(1)
        return out
    monkeypatch.setattr(tsp.EnsembleModels, "__call__", altered)
    correct, table = judged("hippo-tta-bf16", small_driver("hippo-tta-bf16", 5, str(tmp_path)))
    assert not correct, table


@pytest.mark.parametrize("workload,precision", [("hippo-train-f32", "tf32"),
                                                ("msseg2-serve-f32", "tf32"),
                                                ("hippo-tta-bf16", "fp8")])
def test_control_reads_above_the_sound_run(tmp_path, workload, precision):
    driver = small_driver(workload, 5, str(tmp_path))
    sound, control = driver.check(), driver.control(precision)
    assert any(control[n] > 3 * sound[n] for n in control), (sound, control)
