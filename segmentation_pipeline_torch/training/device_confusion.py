"""Self-validating device confusion and instance reductions for validation
sweeps, ported from segmentation_pipeline_tpu/training/device_confusion.py.

The host evaluators count TP/FP/FN/TN from fetched volumes
(evaluators/segmentation_evaluator.py) and label fetched masks to histogram
lesion overlaps (evaluators/instance_segmentation_evaluator.py). When a
sweep needs only those counts (every evaluator is a Segmentation- or
InstanceSegmentationEvaluator on ('y_pred_eval', 'y_eval') and the predictor
argmaxes on the device), the joint histogram (ops/confusion.py) and the
instance overlap histogram (ops/instance.py: device labelling and
fixed-capacity compaction) are computed on the device, and only
(L+1)^2 + (K+1)^2 counts cross per subject.

Correctness is checked in every run: the first eligible sweep runs both
paths (the full fetch, add_evaluation_labels and the host counts, and the
device reduction) and compares the integer counts exactly for every subject
and label. Only on exact agreement does the manager switch "on" (later
sweeps skip the fetch, the attach and the inversion); any mismatch, such as
a label inversion that varies in space in a way the channel probe cannot
represent, turns it "off" for the run (the host path).

The device path's prediction side maps raw argmax CHANNEL ids through
per-channel FULL-SHAPE bucket maps built by probing the SAME inverse
machinery add_evaluation_labels uses (prediction.py EVAL_LABEL_TYPES): for
each channel c, a constant one-hot volume (channel c hot everywhere) runs
through the inversion, recording what channel c becomes at every voxel.
This represents any per-voxel (value, position) map, the masked remaps the
dmri_hippo configuration inverts with included
(CustomRemapLabels(masking_method='Right')), and the probe sweep checks
that it holds for the actual pipeline.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.subject import LabelMap, Subject
from ..evaluators.instance_segmentation_evaluator import (
    DEVICE_INSTANCE_KEY,
    InstanceSegmentationEvaluator,
    connected_components,
    overlap_histogram,
)
from ..evaluators.segmentation_evaluator import (
    SegmentationEvaluator,
    confusion_stats,
    stats_from_joint,
)
from ..ops.confusion import (
    bucketed_joint_from_channel_ids,
    bucketize_values,
    value_lut,
)
from ..transforms.base import apply_inverse_on_new_subject

#: the attribute predictors attach per-subject device joints under and the
#: SegmentationEvaluator fast path reads from
CONFUSION_KEY = "_device_confusion"

#: per-subject device instance-overlap entries the
#: InstanceSegmentationEvaluator fast path reads from:
#: {(pred_name, target_name, connectivity): {"hist", "n_target", "n_pred"}}
#: (the evaluator owns the key)
INSTANCE_KEY = DEVICE_INSTANCE_KEY

_EVAL_NAMES = ("y_pred_eval", "y_eval")
_COUNT_STATS = ("TP", "FP", "TN", "FN")


def sweep_spec(scheduled, predictor):
    """The device-reduction plan for this sweep, or None when ineligible.

    Eligible: the predictor argmaxes on device and every scheduled evaluator
    is either a SegmentationEvaluator (served by confusion counts) or an
    InstanceSegmentationEvaluator (served by the device overlap histogram,
    ops/instance.py), all on ('y_pred_eval', 'y_eval').
    Instance evaluators must agree on connectivity (one CC pass per mask).
    Returns {"confusion": bool, "instance_connectivity": int | None}."""
    if not getattr(predictor, "device_argmax", False):
        return None
    if not scheduled:
        return None
    needs_confusion = False
    inst_conns = set()
    for s in scheduled:
        ev = s.evaluator
        if not (getattr(ev, "prediction_label_map_name", None) == _EVAL_NAMES[0]
                and getattr(ev, "target_label_map_name", None) == _EVAL_NAMES[1]):
            return None
        if isinstance(ev, InstanceSegmentationEvaluator):
            inst_conns.add(ev.connectivity)
        elif isinstance(ev, SegmentationEvaluator):
            needs_confusion = True
        else:
            return None
    if len(inst_conns) > 1:
        return None
    return {"confusion": needs_confusion,
            "instance_connectivity": next(iter(inst_conns), None)}


def eligible_sweep(scheduled, predictor) -> bool:
    """True when this sweep's evaluators can all be served by device
    reductions (see sweep_spec)."""
    return sweep_spec(scheduled, predictor) is not None


def _fetch_all(parts):
    """Every device tensor of ``parts`` (a list of dicts of tensors or
    tuples of tensors) to the host in one transfer: flattened, joined as
    int32 on the device, copied once and cut back into numpy arrays of
    their shapes."""
    tensors = [t for part in parts for v in part.values()
               for t in (v if isinstance(v, tuple) else (v,))]
    if not tensors:
        return [{} for _ in parts]
    flat = torch.cat([t.reshape(-1).to(torch.int32) for t in tensors]).cpu().numpy()
    offset, out = 0, []

    def take(t):
        nonlocal offset
        n = t.numel()
        array = flat[offset:offset + n].reshape(tuple(t.shape))
        offset += n
        return array

    for part in parts:
        out.append({k: tuple(take(t) for t in v) if isinstance(v, tuple) else take(v)
                    for k, v in part.items()})
    return out


class DeviceConfusionManager:
    """Per-training-run state machine: "probe" -> "on" | "off".

    Doubles as the plan object predictors consume (duck interface:
    ``device_joint``, ``deliver``, ``skip_fetch``)."""

    #: device component budget per mask for the instance reduction: the
    #: fetched histogram is (capacity+1)^2 int32 (256 KiB at 255); masks
    #: with more components overflow and take the host path
    instance_capacity = 255

    def __init__(self, label_attributes: Optional[dict] = None):
        self.state = "probe"
        self.label_attributes = label_attributes or {}
        # per-subject caches, keyed by subject name (+ data fingerprint for
        # the host target cache; the device upload is staleness-guarded by
        # Image.device_mirror's own fingerprint)
        self._target_cache: Dict = {}
        self._lut_cache: Dict = {}
        self._probe_stats: Dict = {}
        # sweep plan (configure_sweep): which reductions the current sweep's
        # evaluators need. Defaults preserve the confusion-only behavior for
        # callers that install the manager directly.
        self._needs_confusion = True
        self._instance_conn: Optional[int] = None
        self._probe_inst: Dict = {}
        # reduction kinds the probe has PROVEN so far ("confusion" /
        # ("instance", connectivity)); a sweep needing an unproven kind
        # re-enters probe state instead of running it unvalidated
        self._validated: set = set()
        # component-budget overflows are data-dependent (a noisy early-
        # training prediction can splinter into thousands of specks) and
        # transient — they defer the probe instead of failing it, up to a cap
        self._overflow_probes = 0
        # bytes fetched by deliver(), and subjects delivered, over the run
        self.bytes_fetched = 0
        self.subjects_delivered = 0

    def configure_sweep(self, spec: Optional[dict]) -> None:
        """Install the sweep_spec for the upcoming sweep (trainer side).

        A sweep whose evaluators need a reduction kind the probe never
        validated (e.g. an InstanceSegmentationEvaluator on a longer
        interval than the SegmentationEvaluator that drove the first
        probe) DEMOTES "on" back to "probe": that sweep runs both paths
        and validate_probe() must prove the new kind before any sweep
        skips fetches for it."""
        if spec is None:
            return
        self._needs_confusion = bool(spec.get("confusion"))
        self._instance_conn = spec.get("instance_connectivity")
        if self.state == "on" and not self._needed_kinds() <= self._validated:
            self.state = "probe"

    def _needed_kinds(self) -> set:
        kinds = set()
        if self._needs_confusion:
            kinds.add("confusion")
        if self._instance_conn is not None:
            kinds.add(("instance", self._instance_conn))
        return kinds

    # ------------------------------------------------------------------
    # plan interface used by predictors
    # ------------------------------------------------------------------

    @property
    def skip_fetch(self) -> bool:
        return self.state == "on"

    def _eval_records(self, subject):
        from ..prediction import EVAL_LABEL_TYPES
        from ..transforms.base import filter_records

        return filter_records(subject.get_composed_history(),
                              include_types=EVAL_LABEL_TYPES)

    def _channel_maps_for(self, subject, n_ch: int):
        """(per-channel bucket maps (C, W, H, D) uint8/int32, per-channel
        FOREGROUND maps (C, W, H, D) bool, eval label_values, value LUT)
        for this subject's history.

        For each channel c the probe one-hot volume — channel c hot at
        EVERY voxel — runs through the same filtered inverse records
        add_evaluation_labels applies; the result records what an argmax of
        c at voxel (w, h, d) becomes in eval space.  Exact for any
        per-voxel (value, position) map, including masked remaps.  The
        foreground maps (value > 0 — the instance evaluator's mask
        convention, ref instance_segmentation_evaluator.py:97-98) feed the
        device instance reduction."""
        spatial = tuple(np.asarray(subject["y"].data).shape[1:])
        key = (subject["name"], n_ch, spatial, len(subject.history))
        hit = self._lut_cache.get(key)
        if hit is not None:
            return hit
        records = self._eval_records(subject)
        label_values = None
        channel_vals = []
        for c in range(n_ch):
            probe = np.zeros((n_ch, *spatial), np.float32)
            probe[c] = 1.0
            image = LabelMap(tensor=probe,
                             **copy.deepcopy(self.label_attributes))
            if "X" in subject:
                image.affine = subject["X"].affine.copy()
            out = apply_inverse_on_new_subject(
                records, Subject({"y": image}), warn=False)
            inv = out.get_first_image()
            vals = np.asarray(inv.data)
            if vals.shape != (1, *spatial):
                raise ValueError(
                    f"label inversion changed the probe's shape "
                    f"({vals.shape}) — not a per-voxel value map")
            channel_vals.append(vals[0].astype(np.int64))
            if label_values is None:
                label_values = dict(inv["label_values"])
        L = len(label_values)
        vmax = max(int(v.max(initial=0)) for v in channel_vals)
        vlut = value_lut(label_values, vmax=vmax)
        maps = np.stack([bucketize_values(v, vlut, L + 1)
                         for v in channel_vals])
        fg_maps = np.stack([v > 0 for v in channel_vals])
        result = (maps, fg_maps, label_values, vlut)
        self._lut_cache[key] = result
        return result

    def _target_raw(self, subject) -> np.ndarray:
        """Eval-space target ids (W, H, D) — y inverted through the same
        label-transform records add_evaluation_labels applies."""
        key = (subject["name"], "raw")
        fp = subject["y"]._data_fingerprint(subject["y"].data)
        hit = self._target_cache.get(key)
        if hit is not None and hit[1] == fp:
            return hit[0]
        target_subject = Subject({"y": copy.deepcopy(subject["y"])})
        out = apply_inverse_on_new_subject(
            self._eval_records(subject), target_subject, warn=False)
        ids = np.asarray(out.get_first_image().data)[0]
        self._target_cache[key] = (ids, fp)
        return ids

    def _target_idx(self, subject, vlut: np.ndarray, L: int) -> np.ndarray:
        """Bucketed eval-space target ids (W, H, D) for this subject —
        _target_raw mapped into bucket space with the prediction image's
        value LUT (exactly what confusion_stats does on host)."""
        key = (subject["name"], vlut.tobytes())
        fp = subject["y"]._data_fingerprint(subject["y"].data)
        hit = self._target_cache.get(key)
        if hit is not None and hit[1] == fp:
            return hit[0]
        idx = bucketize_values(self._target_raw(subject), vlut, L + 1)
        self._target_cache[key] = (idx, fp)
        return idx

    def device_joint(self, subject, pred_channel_ids, n_ch: int):
        """Device reductions for one subject — a record carrying the
        (L+1, L+1) confusion joint and/or the instance overlap histogram
        (whichever the sweep spec needs) — or None when the subject cannot
        be covered (no target, probe failure).  pred_channel_ids: device
        (W, H, D) argmax channel ids, already cropped to the subject's true
        spatial shape."""
        if self.state == "off" or "y" not in subject:
            return None
        device = pred_channel_ids.device
        try:
            maps, fg_maps, label_values, vlut = \
                self._channel_maps_for(subject, n_ch)
            L = len(label_values)
            target_host = self._target_idx(subject, vlut, L)
            if tuple(target_host.shape) != tuple(pred_channel_ids.shape) \
                    or tuple(maps.shape[1:]) != tuple(pred_channel_ids.shape):
                return None
            record = {"label_values": label_values}
            if self._needs_confusion:
                t_dev = subject["y"].device_mirror(
                    ("confusion_idx", vlut.tobytes(), str(device)),
                    lambda _data: torch.as_tensor(
                        self._target_idx(subject, vlut, L), device=device))
                maps_dev = subject["y"].device_mirror(
                    ("confusion_maps", n_ch, vlut.tobytes(), str(device)),
                    lambda _data: torch.as_tensor(
                        self._channel_maps_for(subject, n_ch)[0], device=device))
                record["joint"] = bucketed_joint_from_channel_ids(
                    t_dev, pred_channel_ids, maps_dev, L + 1)
            if self._instance_conn is not None:
                from ..ops.instance import instance_hist_from_channel_ids

                tfg_dev = subject["y"].device_mirror(
                    ("instance_target_fg", str(device)),
                    lambda _data: torch.as_tensor(self._target_raw(subject) > 0,
                                                  device=device))
                fg_dev = subject["y"].device_mirror(
                    ("instance_fg_maps", n_ch, str(device)),
                    lambda _data: torch.as_tensor(
                        self._channel_maps_for(subject, n_ch)[1], device=device))
                record["inst"] = instance_hist_from_channel_ids(
                    tfg_dev, pred_channel_ids, fg_dev,
                    capacity=self.instance_capacity,
                    connectivity=self._instance_conn)
            return record
        except Exception as e:  # noqa: BLE001 — any failure here means the host path
            if self.state == "probe":
                print(f"device confusion probe failed for "
                      f"{subject.get('name')}: {e} — using the host path")
            self.state = "off"
            return None

    def deliver(self, pairs: Sequence) -> list:
        """Fetch all pending device reductions in ONE transfer and attach
        the per-subject entries the evaluator fast paths consume.
        pairs: [(subject, record from device_joint), ...].  Returns the
        subjects whose entries were FULLY delivered — a subject whose
        instance reduction overflowed the component budget is omitted and
        must take the host path (the caller late-fetches its prediction)."""
        if not pairs:
            return []
        fetched = _fetch_all([{k: v for k, v in rec.items() if k in ("joint", "inst")}
                              for _, rec in pairs])
        self.bytes_fetched += sum(a.nbytes for host in fetched for v in host.values()
                                  for a in (v if isinstance(v, tuple) else (v,)))
        delivered = []
        for (subject, rec), host in zip(pairs, fetched):
            label_values = rec["label_values"]
            complete = True
            if "joint" in host:
                entry = subject.get(CONFUSION_KEY)
                if not isinstance(entry, dict):
                    entry = {}
                    subject[CONFUSION_KEY] = entry
                entry[_EVAL_NAMES] = {"joint": host["joint"],
                                      "label_values": dict(label_values)}
                if self.state == "probe":
                    self._probe_stats[subject["name"]] = \
                        stats_from_joint(host["joint"],
                                         list(label_values.keys()))
            if "inst" in host:
                from ..ops.instance import component_count

                hist, t_uniq, p_uniq = host["inst"]
                n_t, ov_t = component_count(t_uniq)
                n_p, ov_p = component_count(p_uniq)
                if ov_t or ov_p:
                    complete = False
                else:
                    inst_entry = {
                        "hist": hist[:n_t + 1, :n_p + 1].astype(np.float64),
                        "n_target": n_t, "n_pred": n_p,
                    }
                    entries = subject.get(INSTANCE_KEY)
                    if not isinstance(entries, dict):
                        entries = {}
                        subject[INSTANCE_KEY] = entries
                    entries[(*_EVAL_NAMES, self._instance_conn)] = inst_entry
                    if self.state == "probe":
                        self._probe_inst[subject["name"]] = inst_entry
            if complete:
                delivered.append(subject)
        self.subjects_delivered += len(pairs)
        return delivered

    # ------------------------------------------------------------------
    # probe-sweep validation (trainer side)
    # ------------------------------------------------------------------

    def _strip_entries(self, subjects) -> None:
        """Strip the entries deliver() attached this sweep, so the
        evaluators (which run after this check, trainer.py) fall back to
        the host chain instead of consuming unvalidated counts."""
        self._probe_stats.clear()
        self._probe_inst.clear()
        for subject in subjects:
            subject.pop(CONFUSION_KEY, None)
            subject.pop(INSTANCE_KEY, None)

    def _fail_probe(self, subjects) -> None:
        """Disable the device path permanently AND strip this sweep's
        entries."""
        self.state = "off"
        self._strip_entries(subjects)

    def _defer_probe(self, subjects) -> None:
        """Instance component-budget overflow: data-dependent and transient
        (predictions consolidate as training progresses) — strip this
        sweep's entries and RETRY the probe next sweep, up to a cap."""
        self._overflow_probes += 1
        if self._overflow_probes > 8:
            print("device instance reduction: component budget overflowed "
                  f"{self._overflow_probes} probe sweeps in a row — using "
                  "the host path")
            self._fail_probe(subjects)
            return
        self._strip_entries(subjects)

    def validate_probe(self, subjects) -> None:
        """Compare the device reductions captured this sweep against the
        host chain's, subject by subject, exactly.  All-equal -> "on"; any
        mismatch or missing subject -> "off" (overflowed instance budgets
        defer instead).  Call at the end of any sweep that STARTED in probe
        state (skip_fetch was False, so every subject carries full host
        predictions and stripping is always safe)."""
        if self.state == "off":
            # device_joint failed mid-sweep: entries attached earlier in
            # this sweep were never validated — strip them
            self._fail_probe(subjects)
            return
        if self.state != "probe":
            return
        for subject in subjects:
            name = subject["name"]
            if _EVAL_NAMES[0] not in subject or _EVAL_NAMES[1] not in subject:
                self._fail_probe(subjects)
                return
            if self._needs_confusion:
                device_stats = self._probe_stats.get(name)
                if device_stats is None:
                    self._fail_probe(subjects)
                    return
                label_values = subject[_EVAL_NAMES[0]]["label_values"]
                host = confusion_stats(
                    np.asarray(subject[_EVAL_NAMES[0]].data),
                    np.asarray(subject[_EVAL_NAMES[1]].data), label_values)
                for stat in _COUNT_STATS:
                    for label in label_values:
                        if host[stat][label] != device_stats[stat].get(label):
                            print(f"device confusion mismatch on {name} "
                                  f"{label}.{stat}: host {host[stat][label]} "
                                  f"vs device "
                                  f"{device_stats[stat].get(label)} — "
                                  f"using the host path")
                            self._fail_probe(subjects)
                            return
            if self._instance_conn is not None:
                entry = self._probe_inst.get(name)
                if entry is None:
                    # deliver() omitted it: component-budget overflow
                    self._defer_probe(subjects)
                    return
                conn = self._instance_conn
                pred_mask = np.asarray(subject[_EVAL_NAMES[0]].data)[0] > 0
                target_mask = np.asarray(subject[_EVAL_NAMES[1]].data)[0] > 0
                pc, M = connected_components(pred_mask, conn)
                tc, N = connected_components(target_mask, conn)
                if (N, M) != (entry["n_target"], entry["n_pred"]) or \
                        not np.array_equal(overlap_histogram(tc, pc, N, M),
                                           entry["hist"]):
                    print(f"device instance-overlap mismatch on {name}: "
                          f"host ({N}, {M}) components vs device "
                          f"({entry['n_target']}, {entry['n_pred']}) — "
                          f"using the host path")
                    self._fail_probe(subjects)
                    return
        self._probe_stats.clear()
        self._probe_inst.clear()
        self.state = "on"
        self._validated |= self._needed_kinds()
        kinds = [k for k, on in (("confusion", self._needs_confusion),
                                 ("instance", self._instance_conn is not None))
                 if on]
        print(f"device {'+'.join(kinds)} validated: validation "
              "sweeps now reduce on device (fetching counts, not volumes)")
