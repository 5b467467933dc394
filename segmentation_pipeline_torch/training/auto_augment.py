"""Derive the device-augmentation config from a declared pipeline.

Ported from segmentation_pipeline_tpu/training/auto_augment.py. The
training transform is the experiment's definition, so
``device_augmentation="auto"`` calls :func:`derive_device_augmentation` to

1. split the declared training pipeline into a deterministic host pipeline
   (preprocessing prefix and model-io suffix, which the device cache's
   pretransform may freeze) and the stochastic augmentation window;
2. map every stochastic transform of the window onto its stage of
   ``ops/augment.py`` (permute, flip, affine, elastic, bias, gamma, blur,
   noise and the interleaved RescaleIntensity stages), keeping
   probabilities, parameter ranges and OneOf structure;
3. raise :class:`AugmentationDerivationError` where a stochastic transform
   has no faithful device counterpart, rather than freeze one draw into
   the device cache or drop an augmentation.

Blur std and elastic displacement are in mm on the host and are converted
to voxels with the spacing the volumes have at the augmentation point.
The device stages apply to the collated X and y only (the host pipeline
augments every image of the subject), interpolate trilinearly, approximate
'otsu' padding by the mean below the channel mean, and for patch training
augment the sampled patch rather than the whole volume. The elastic field
uses the host's own separable cubic-B-spline matrices.

Host code over the port's transform classes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..transforms import (
    Compose,
    ConcatenateImages,
    CopyProperty,
    CustomArgMax,
    CustomOneHot,
    CustomRemapLabels,
    CustomRemoveLabels,
    CustomSequentialLabels,
    FindInterestingSlice,
    ImageFromLabels,
    OneOf,
    RandomAffine,
    RandomBiasField,
    RandomBlur,
    RandomElasticDeformation,
    RandomFlip,
    RandomGamma,
    RandomNoise,
    RandomPermuteDimensions,
    RandomTransform,
    RenameProperty,
    ReplaceNan,
    RescaleIntensity,
    SetDataType,
    Transform,
)
from ..transforms.base import _with_extra_exclude


class AugmentationDerivationError(ValueError):
    """A declared transform cannot be mapped onto the fused device pipeline."""


def contains_random(transform: Optional[Transform]) -> bool:
    """True if applying ``transform`` draws any randomness: RandomTransform
    subclasses, OneOf choices, or any probabilistic gate (p < 1).  The
    device-cache frozen-aug guard: a pipeline for which this returns True
    must never be pretransform-frozen into the device cache."""
    if transform is None:
        return False
    if getattr(transform, "p", 1.0) < 1.0:
        return True
    if isinstance(transform, OneOf):
        return True
    if isinstance(transform, RandomTransform):
        return True
    if isinstance(transform, Compose):
        return any(contains_random(t) for t in transform.transforms)
    return False


def _flatten(children: Sequence[Transform], exclude=None) -> List[Transform]:
    """Expand Compose nodes that contain randomness (their children must be
    individually mapped); keep fully-deterministic Compose blocks whole so
    the reconstructed host pipeline preserves their structure.  Compose-level
    exclude lists propagate onto kept children (base.py Compose semantics)."""
    out = []
    for t in children:
        if isinstance(t, Compose) and contains_random(t):
            if t.p < 1.0:
                raise AugmentationDerivationError(
                    f"Compose(p={t.p}) with stochastic content has no device "
                    f"counterpart — gate the individual transforms instead")
            merged = list(set((exclude or []) + (t.exclude or [])))
            out += _flatten(t.transforms, merged or None)
        else:
            out.append(_with_extra_exclude(t, exclude) if exclude else t)
    return out


def _require(cond: bool, message: str):
    if not cond:
        raise AugmentationDerivationError(message)


def _name(t) -> str:
    return type(t).__name__


# ---------------------------------------------------------------------------
# per-transform parameter extraction
# ---------------------------------------------------------------------------

def _map_flip(t: RandomFlip, cfg: Dict):
    _require(t.p == 1.0, f"RandomFlip(p={t.p}) — the device flip gates per "
                         f"axis only; use flip_probability")
    cfg["flip_axes"] = tuple(t.axes)
    cfg["flip_p"] = float(t.flip_probability)


def _map_permute(t: RandomPermuteDimensions, cfg: Dict):
    cfg["permute_p"] = float(t.p)


def _map_elastic(t: RandomElasticDeformation, cfg: Dict,
                 spacing: Tuple[float, float, float], p: float):
    cfg["elastic_p"] = float(p)
    cfg["elastic_cp"] = tuple(int(c) for c in t.num_control_points)
    cfg["elastic_locked_borders"] = int(t.locked_borders)
    cfg["elastic_max_displacement"] = tuple(
        float(md) / float(sp) for md, sp in zip(t.max_displacement, spacing))


def _map_affine(t: RandomAffine, cfg: Dict, p: float):
    _require(tuple(t.translation) == (0.0, 0.0),
             f"RandomAffine(translation={t.translation}) — the device affine "
             f"stage warps about the center without translation")
    cfg["affine_p"] = float(p)
    cfg["affine_scales"] = tuple(float(s) for s in t.scales)
    cfg["affine_degrees"] = tuple(float(d) for d in t.degrees)
    pad = t.default_pad_value
    if isinstance(pad, str):
        _require(pad in ("minimum", "mean", "otsu"),
                 f"RandomAffine(default_pad_value={pad!r}) unsupported on "
                 f"device — use 'minimum'/'mean'/'otsu' or a number")
        cfg["affine_pad"] = pad
    else:
        cfg["affine_pad"] = float(pad)


def _map_bias(t: RandomBiasField, cfg: Dict):
    cfg["bias_p"] = float(t.p)
    cfg["bias_coefficients"] = tuple(float(c) for c in t.coefficients)
    cfg["bias_order"] = int(t.order)


def _map_gamma(t: RandomGamma, cfg: Dict):
    cfg["gamma_p"] = float(t.p)
    cfg["log_gamma"] = tuple(float(g) for g in t.log_gamma)


def _map_noise(t: RandomNoise, cfg: Dict):
    mean = t.mean
    mean_ok = (tuple(mean) == (0.0, 0.0) if isinstance(mean, (tuple, list))
               else float(mean) == 0.0)
    _require(mean_ok,
             f"RandomNoise(mean={mean}) — the device noise stage is zero-mean")
    cfg["noise_p"] = float(t.p)
    cfg["noise_std"] = (tuple(float(s) for s in t.std)
                        if isinstance(t.std, (tuple, list)) else float(t.std))


def _map_blur(t: RandomBlur, cfg: Dict,
              spacing: Tuple[float, float, float]):
    cfg["blur_p"] = float(t.p)
    cfg["blur_std"] = tuple(float(s) for s in t.std)
    cfg["blur_spacing"] = tuple(float(s) for s in spacing)


def _blur_noise_members(ts) -> Optional[Tuple[RandomBlur, RandomNoise]]:
    """(blur, noise) if ts is exactly one RandomBlur + one RandomNoise."""
    if len(ts) != 2:
        return None
    by_type = {type(t) for t in ts}
    if by_type != {RandomBlur, RandomNoise}:
        return None
    blur = next(t for t in ts if isinstance(t, RandomBlur))
    noise = next(t for t in ts if isinstance(t, RandomNoise))
    return blur, noise


def _map_blur_noise_oneof(t: OneOf, cfg: Dict, spacing) -> None:
    """OneOf([Compose([blur, noise]), Compose([noise, blur])]) — the dmri
    order-randomized pair (ref main_config.py:96-99)."""
    _require(t.p == 1.0, f"OneOf(p={t.p}) of blur/noise orders unsupported")
    _require(len(t.transforms) == 2 and all(
        isinstance(b, Compose) for b in t.transforms),
        "OneOf of blur/noise must hold two Compose branches")
    _require(abs(t.weights[0] - t.weights[1]) < 1e-9,
             "OneOf of blur/noise orders must be equally weighted — the "
             "device order flip is a fair coin")
    pairs = [_blur_noise_members(b.transforms) for b in t.transforms]
    _require(all(p is not None for p in pairs),
             "OneOf branches must each be Compose([RandomBlur, RandomNoise]) "
             "in some order")
    (b1, n1), (b2, n2) = pairs
    _require(b1.std == b2.std and b1.p == b2.p and n1.std == n2.std
             and n1.p == n2.p and n1.mean == n2.mean,
             "blur/noise parameters must match across the two OneOf orders")
    first = t.transforms[0].transforms[0]
    _require(isinstance(first, (RandomBlur, RandomNoise)),
             "unexpected OneOf branch structure")
    _map_blur(b1, cfg, spacing)
    _map_noise(n1, cfg)
    cfg["blur_noise_order"] = "random"


def _map_spatial_oneof(t: OneOf, cfg: Dict, spacing) -> None:
    """OneOf({elastic: w, affine: w'}, p) — the msseg2 spatial choice
    (ref msseg2.py:47-50): with prob p exactly one of them applies."""
    w_aff = w_ela = 0.0
    for member, weight in zip(t.transforms, t.weights):
        _require(getattr(member, "p", 1.0) == 1.0,
                 f"{_name(member)}(p=...) inside a spatial OneOf — gate with "
                 f"the OneOf weights instead")
        if isinstance(member, RandomAffine):
            _map_affine(member, cfg, p=0.0)
            w_aff = float(weight)
        elif isinstance(member, RandomElasticDeformation):
            _map_elastic(member, cfg, spacing, p=0.0)
            w_ela = float(weight)
        else:
            raise AugmentationDerivationError(
                f"OneOf member {_name(member)} is not a spatial transform "
                f"the device pipeline can choose between")
    cfg["spatial_mode"] = "oneof"
    cfg["oneof_p"] = float(t.p)
    total = w_aff + w_ela
    cfg["oneof_affine_weight"] = w_aff / total if total else 0.0
    # per-branch probabilities live in the oneof gates
    cfg["affine_p"] = 0.0
    cfg["elastic_p"] = 0.0


# ---------------------------------------------------------------------------
# the derivation
# ---------------------------------------------------------------------------

# device stage order (ops/augment.py): rank enforces that the declared
# pipeline is expressible by the fused program's fixed stage sequence
_STAGE_RANK = {"permute": 0, "flip": 1, "spatial": 2, "bias": 3,
               "mid_rescale": 4, "gamma": 5, "pre_noise_rescale": 6,
               "blur_noise": 7}

# deterministic transforms that commute past the device augmentation when
# they appear AFTER the stochastic window (the model-io stage): structural
# renames/concats and label encodings act identically before or after the
# augs; RescaleIntensity is special-cased (re-applied on device post-aug)
_COMMUTING_SUFFIX = (ConcatenateImages, RenameProperty, CopyProperty,
                     CustomOneHot, CustomArgMax, CustomRemapLabels,
                     CustomRemoveLabels, CustomSequentialLabels,
                     SetDataType, ReplaceNan, ImageFromLabels,
                     FindInterestingSlice, RescaleIntensity)


def _compose_leaves(ts: Sequence[Transform]):
    """Flatten Compose nesting into leaf transforms, preserving order
    (shared by the include/exclude faithfulness guard and the hybrid
    derivation so the two traces can never drift apart)."""
    for t in ts:
        sub = getattr(t, "transforms", None)
        if isinstance(t, Compose) and sub is not None:
            yield from _compose_leaves(sub)
        else:
            yield t


def _trace_batch_sources(suffix_leaves: Sequence[Transform], seed) -> set:
    """Walk the (ordered) suffix leaves BACKWARD propagating which image
    names feed the ``seed`` names through Concatenate/Rename/Copy."""
    sources = set(seed)
    for t in reversed(list(suffix_leaves)):
        if getattr(t, "new_image_name", None) in sources:
            sources |= set(getattr(t, "image_names", []) or [])
        if getattr(t, "new_name", None) in sources and \
                getattr(t, "old_name", None):
            sources.add(t.old_name)
    return sources


def _check_suffix(items: Sequence[Transform]):
    for t in items:
        if isinstance(t, Compose):
            _check_suffix(t.transforms)
            continue
        if not isinstance(t, _COMMUTING_SUFFIX):
            raise AugmentationDerivationError(
                f"{_name(t)} appears AFTER the stochastic augmentation block "
                f"but does not commute with device-side augmentation (it "
                f"would see un-augmented data on host). Reorder the pipeline "
                f"or augment on host.")


def _last_rescale(items: Sequence[Transform]) -> Optional[RescaleIntensity]:
    last = None
    for t in items:
        if isinstance(t, Compose):
            last = _last_rescale(t.transforms) or last
        elif isinstance(t, RescaleIntensity):
            last = t
    return last


def derive_device_augmentation(
    transform: Optional[Transform],
    spacing: Optional[Tuple[float, float, float]] = None,
) -> Tuple[Optional[Transform], Optional[Dict]]:
    """Split ``transform`` into (deterministic host pipeline, fused device
    augmentation config).

    Returns ``(transform, None)`` when the pipeline draws no randomness
    (nothing to move on device).  Raises AugmentationDerivationError when a
    stochastic transform cannot be mapped faithfully.  ``spacing`` is the
    voxel spacing (mm) at the augmentation point, used to convert the host
    transforms' mm-parameterized blur/elastic to voxels; None assumes
    isotropic 1 mm.
    """
    if transform is None or not contains_random(transform):
        return transform, None
    spacing = tuple(float(s) for s in (spacing or (1.0, 1.0, 1.0)))

    items = _flatten([transform])
    rand_flags = [contains_random(t) for t in items]
    i0 = rand_flags.index(True)
    i1 = len(items) - 1 - rand_flags[::-1].index(True)
    prefix, window, suffix = items[:i0], items[i0:i1 + 1], items[i1 + 1:]

    # everything OFF; the window switches stages on
    cfg: Dict = dict(
        permute_p=0.0, flip_axes=(0, 1, 2), flip_p=0.0,
        spatial_mode="independent", affine_p=0.0, elastic_p=0.0,
        bias_p=0.0, mid_rescale=None, gamma_p=0.0, pre_noise_rescale=None,
        blur_p=0.0, noise_p=0.0, blur_noise_order="blur_noise",
        rescale=None,
    )

    cursor = -1
    n_rescales = 0
    blur_seen = noise_seen = False

    def advance(stage: str, t):
        nonlocal cursor
        rank = _STAGE_RANK[stage]
        _require(rank >= cursor,
                 f"{_name(t)} appears out of order for the fused device "
                 f"pipeline (stage '{stage}' after rank {cursor}); the device "
                 f"program's stage order is fixed: "
                 f"{' -> '.join(_STAGE_RANK)}")
        cursor = rank

    # The fused device stages apply to the whole collated X (and warp y):
    # a host include=/exclude= restriction is only faithful when it cannot
    # change what reaches the device batch.  Trace which host images feed
    # X/y (backward through the suffix's Concatenate/Rename/Copy — ref
    # main_config.py:158-165 builds X AFTER the augmentation block) and
    # refuse restrictions that touch those sources; restrictions on images
    # the device batch never sees (the reference's exclude=['full_dwi'],
    # ref main_config.py:86-100) derive fine.
    # _flatten keeps deterministic Compose blocks whole (both reference
    # configs wrap the model-io Concatenate/Rename in exactly such a
    # Compose, ref main_config.py:158-165 / msseg2.py:59-66), so the trace
    # must recurse into them — a top-level-only scan would miss the
    # Concatenate that builds X and leave the guard vacuous.
    sources = _trace_batch_sources(list(_compose_leaves(suffix)), ("X", "y"))

    def _walk(t):
        yield t
        for m in (getattr(t, "transforms", []) or []):
            yield from _walk(m)

    def _require_faithful_selection(t):
        for m in _walk(t):
            excluded = set(getattr(m, "exclude", None) or [])
            _require(not (excluded & sources),
                     f"{_name(m)} excludes {sorted(excluded & sources)} "
                     f"which feed the device batch — the fused stage would "
                     f"augment them anyway; keep this transform on host "
                     f"(device_augmentation=None, device_cache=False)")
            _require(getattr(m, "include", None) is None,
                     f"{_name(m)} restricts its targets with include= — "
                     f"the fused device pipeline applies each stage to the "
                     f"whole collated batch; keep this transform on host "
                     f"(device_augmentation=None, device_cache=False)")

    for t in window:
        _require_faithful_selection(t)
        if isinstance(t, RandomPermuteDimensions):
            advance("permute", t)
            _map_permute(t, cfg)
        elif isinstance(t, RandomFlip):
            advance("flip", t)
            _map_flip(t, cfg)
        elif isinstance(t, RandomElasticDeformation):
            advance("spatial", t)
            _require(cfg["elastic_p"] == 0.0 and cfg["spatial_mode"] ==
                     "independent", "multiple elastic stages declared")
            _map_elastic(t, cfg, spacing, p=t.p)
        elif isinstance(t, RandomAffine):
            advance("spatial", t)
            _require(cfg["affine_p"] == 0.0 and cfg["spatial_mode"] ==
                     "independent", "multiple affine stages declared")
            _map_affine(t, cfg, p=t.p)
        elif isinstance(t, OneOf):
            members = t.transforms
            if all(isinstance(m, (RandomAffine, RandomElasticDeformation))
                   for m in members):
                advance("spatial", t)
                _map_spatial_oneof(t, cfg, spacing)
            else:
                advance("blur_noise", t)
                _map_blur_noise_oneof(t, cfg, spacing)
                blur_seen = noise_seen = True
        elif isinstance(t, RandomBiasField):
            advance("bias", t)
            _map_bias(t, cfg)
        elif isinstance(t, RescaleIntensity):
            _require(n_rescales < 2,
                     "more than two RescaleIntensity stages inside the "
                     "augmentation window — the device pipeline has two "
                     "(post-bias and pre-noise)")
            stage = "mid_rescale" if n_rescales == 0 else "pre_noise_rescale"
            advance(stage, t)
            cfg[stage] = tuple(float(v) for v in t.out_min_max)
            key = ("mid_rescale_percentiles" if stage == "mid_rescale"
                   else None)
            if key is not None:
                cfg[key] = tuple(float(v) for v in t.percentiles)
            else:
                _require(tuple(t.percentiles) == (0.0, 100.0),
                         f"pre-noise RescaleIntensity with percentiles "
                         f"{t.percentiles} — the device stage rescales by "
                         f"min/max (tio default)")
            n_rescales += 1
        elif isinstance(t, RandomGamma):
            advance("gamma", t)
            _map_gamma(t, cfg)
        elif isinstance(t, RandomBlur):
            advance("blur_noise", t)
            _require(not blur_seen, "multiple RandomBlur stages declared")
            _map_blur(t, cfg, spacing)
            blur_seen = True
            if noise_seen:
                cfg["blur_noise_order"] = "noise_blur"
        elif isinstance(t, RandomNoise):
            advance("blur_noise", t)
            _require(not noise_seen, "multiple RandomNoise stages declared")
            _map_noise(t, cfg)
            noise_seen = True
            if blur_seen:
                cfg["blur_noise_order"] = "blur_noise"
        else:
            raise AugmentationDerivationError(
                f"{_name(t)} has no fused device-augmentation counterpart — "
                f"move it out of the stochastic block (deterministic "
                f"transforms) or augment on host "
                f"(device_augmentation=None, device_cache=False). "
                f"Host-only channel resynthesis (ReconstructMeanDWI-style) "
                f"at the START of the stochastic window is supported by the "
                f"hybrid fast path: the trainer derives it automatically "
                f"(derive_hybrid_augmentation) — the regenerated channel is "
                f"re-uploaded per batch while the static channels stay "
                f"device-cached.")

    _check_suffix(suffix)
    final = _last_rescale(suffix)
    if final is not None:
        cfg["rescale"] = tuple(float(v) for v in final.out_min_max)
        cfg["rescale_percentiles"] = tuple(float(v) for v in final.percentiles)

    host = Compose(prefix + suffix)
    return host, cfg


# ---------------------------------------------------------------------------
# Hybrid derivation: host-only channel resynthesis + fused device stages
# ---------------------------------------------------------------------------

def _hybrid_outputs(t) -> Optional[List[str]]:
    """Image names a host-only stochastic transform (re)generates, or None
    when the transform has no hybrid contract.  ReconstructMeanDWI and
    ReconstructMeanDWIClassic (ref transforms/reconstruct_mean_dwi.py:11-172)
    declare theirs via ``mean_dwi_image_name``."""
    name = getattr(t, "mean_dwi_image_name", None)
    if name is not None and isinstance(t, RandomTransform):
        return [name]
    return None


def _hybrid_inputs(t) -> List[str]:
    """Image names a peeled transform READS (must stay pristine through the
    cacheable pretransform so every per-batch resynthesis sees exactly the
    data the declared order would — the reference host path retransforms
    from the original subject each iteration)."""
    name = getattr(t, "full_dwi_image_name", None)
    return [name] if name is not None else []


class HybridSpec:
    """Per-batch host stage of a hybrid augmentation derivation.

    ``peeled``: the host-only stochastic transforms (applied to a scratch
    shallow copy of the pretransformed subject each batch).  ``finishers``:
    the deterministic suffix data steps re-applied to the regenerated images
    only (restricted clones — the cache already applied them to the static
    channels at pretransform).  ``slots``: {image_name: (channel_offset,
    n_channels)} inside the collated X.  ``image_order``: affected image
    names in concatenation order.  ``host_inline``: the reordered host
    pipeline for the no-device-cache deployment (prefix + peeled + suffix;
    the stochastic window still runs on device)."""

    def __init__(self, peeled, finishers, slots, image_order, host_inline):
        self.peeled = peeled
        self.finishers = finishers
        self.slots = slots
        self.image_order = image_order
        self.host_inline = host_inline

    @property
    def n_channels(self) -> int:
        return sum(n for _, n in self.slots.values())

    def __repr__(self):
        names = [type(t).__name__ for t in self.peeled]
        return (f"HybridSpec(peeled={names}, images={self.image_order}, "
                f"channels={self.n_channels})")


def derive_hybrid_augmentation(
    transform: Optional[Transform],
    spacing: Optional[Tuple[float, float, float]] = None,
) -> Tuple[Optional[Transform], Optional[Dict], Optional[HybridSpec]]:
    """:func:`derive_device_augmentation` extended with the hybrid fast path
    for the augmentation-ablation experiment (ref configs/augmentation.py:41-50):
    host-only stochastic channel-resynthesis transforms at the START of the
    stochastic window (ReconstructMeanDWI) are peeled into a per-batch host
    stage instead of refusing the whole pipeline.  The device cache then
    holds the static channels; each batch the host regenerates only the
    affected images, re-applies the suffix intensity steps to them, and the
    trainer uploads + splices that channel block into the gathered cached X
    before the derived fused device stages run
    (training/hybrid_augment.py).

    Returns ``(host_pipeline, device_config, hybrid_spec)``; ``hybrid_spec``
    is None when the plain derivation suffices.  The cacheable host pipeline
    EXCLUDES the peeled transforms' input images (full_dwi) from the suffix
    steps: the declared order applies the model-io intensity steps AFTER the
    resynthesis, and the reference host path retransforms from the original
    subject every iteration — so the per-batch regeneration must read the
    pristine (prefix-preprocessed) series, not a suffix-rescaled (and
    percentile-CLIPPED) copy baked once at pretransform."""
    if transform is None or not contains_random(transform):
        return transform, None, None

    items = _flatten([transform])
    rand_flags = [contains_random(t) for t in items]
    i0 = rand_flags.index(True)
    i1 = len(items) - 1 - rand_flags[::-1].index(True)
    prefix, window, suffix = items[:i0], list(items[i0:i1 + 1]), items[i1 + 1:]

    peeled = []
    while window and _hybrid_outputs(window[0]) is not None:
        peeled.append(window.pop(0))
    if not peeled:
        host, cfg = derive_device_augmentation(transform, spacing)
        return host, cfg, None
    if window and not contains_random(window[0]):
        raise AugmentationDerivationError(
            f"hybrid split: deterministic {_name(window[0])} between the "
            f"peeled host stage and the device window would apply at "
            f"pretransform time, BEFORE the per-batch resynthesis — "
            f"reorder it before {_name(peeled[0])} or into the suffix")
    for t in window:
        _require(_hybrid_outputs(t) is None,
                 f"{_name(t)} resynthesizes a channel mid-window; the hybrid "
                 f"host stage only supports resynthesis at the window start "
                 f"(device stages in between cannot run on host)")

    rebuilt = Compose(prefix + window + suffix)
    _, cfg = derive_device_augmentation(rebuilt, spacing)

    affected: List[str] = []
    for t in peeled:
        for n in _hybrid_outputs(t):
            if n not in affected:
                affected.append(n)
    inputs: List[str] = []
    for t in peeled:
        for n in _hybrid_inputs(t):
            if n not in inputs:
                inputs.append(n)

    suffix_leaves = list(_compose_leaves(suffix))
    concat = next((t for t in suffix_leaves
                   if isinstance(t, ConcatenateImages)
                   and t.new_image_name == "X"), None)
    _require(concat is not None,
             f"hybrid fast path: the deterministic suffix declares no "
             f"ConcatenateImages building 'X', so the channel slots of "
             f"{affected} in the device batch cannot be located")
    _require(set(affected) <= set(concat.image_names),
             f"hybrid fast path: {sorted(set(affected) - set(concat.image_names))} "
             f"regenerated by {_name(peeled[0])} never feed the collated X "
             f"({list(concat.image_names)}) — the per-batch resynthesis "
             f"would be dead work; keep this transform on host")
    _require(not (set(inputs) & set(concat.image_names)),
             f"hybrid fast path: {sorted(set(inputs) & set(concat.image_names))} "
             f"both feed the collated X directly AND drive the per-batch "
             f"resynthesis — the pretransform must keep resynthesis inputs "
             f"pristine, which would corrupt their cached X channel; keep "
             f"this pipeline on host")

    y_sources = _trace_batch_sources(suffix_leaves, ("y",))
    _require(not (set(affected) & y_sources),
             f"hybrid fast path: {sorted(set(affected) & y_sources)} feed "
             f"the label y — labels live in the device cache and cannot be "
             f"regenerated per batch")

    # data-modifying steps AFTER the concat operate on the collated X: the
    # static channels bake them at pretransform, but the regenerated block
    # cannot reproduce statistics computed over the whole X — refuse rather
    # than silently train on inconsistently scaled channels
    after_concat = suffix_leaves[suffix_leaves.index(concat) + 1:]
    for t in after_concat:
        if isinstance(t, (RescaleIntensity, ReplaceNan, SetDataType)):
            targets = {"X", *affected}
            inc = None if t.include is None else set(t.include)
            exc = set(t.exclude or [])
            touches = (targets - exc) if inc is None else (targets & inc) - exc
            _require(not touches,
                     f"{_name(t)} modifies {sorted(touches)} AFTER the "
                     f"ConcatenateImages building X — the cached static "
                     f"channels bake it at pretransform but the per-batch "
                     f"regenerated channel cannot reproduce it; move it "
                     f"before the concatenation or keep this pipeline on "
                     f"host (device_augmentation=None, device_cache=False)")

    slots: Dict[str, Tuple[int, int]] = {}
    off = 0
    for name, ch in zip(concat.image_names, concat.image_channels):
        if name in affected:
            slots[name] = (off, int(ch))
        off += int(ch)

    import copy as _copy

    finishers: List[Transform] = []
    for t in suffix_leaves:
        if t is concat:
            break
        if isinstance(t, (RescaleIntensity, ReplaceNan, SetDataType)):
            inc = set(affected) if t.include is None \
                else set(affected) & set(t.include)
            inc -= set(t.exclude or [])
            if inc:
                t2 = _copy.copy(t)
                t2.include = sorted(inc)
                t2.exclude = None
                finishers.append(t2)

    # the cacheable host pipeline: deterministic remainder with the
    # resynthesis INPUTS excluded from the suffix — e.g. the dmri model-io
    # RescaleIntensity (ref main_config.py:161, no exclude) would otherwise
    # percentile-CLIP full_dwi once at pretransform, and mean-of-clipped !=
    # the declared clip-after-mean order
    host = Compose(prefix + [_with_extra_exclude(t, inputs) for t in suffix]) \
        if inputs else Compose(prefix + suffix)

    spec = HybridSpec(
        peeled=peeled, finishers=finishers, slots=slots,
        image_order=[n for n in concat.image_names if n in affected],
        host_inline=Compose(prefix + peeled + suffix))
    return host, cfg, spec


def describe_config(cfg: Dict) -> str:
    """One-line human summary of a derived config (trainer startup log)."""
    on = []
    if cfg.get("permute_p", 0):
        on.append(f"permute(p={cfg['permute_p']})")
    if cfg.get("flip_p", 0):
        on.append(f"flip(axes={cfg['flip_axes']}, p={cfg['flip_p']})")
    if cfg.get("spatial_mode") == "oneof":
        on.append(f"oneof(p={cfg['oneof_p']}, "
                  f"affine_w={cfg['oneof_affine_weight']:.2f})")
    else:
        if cfg.get("affine_p", 0):
            on.append(f"affine(p={cfg['affine_p']})")
        if cfg.get("elastic_p", 0):
            on.append(f"elastic(p={cfg['elastic_p']})")
    if cfg.get("bias_p", 0):
        on.append(f"bias(p={cfg['bias_p']})")
    if cfg.get("gamma_p", 0):
        on.append(f"gamma(p={cfg['gamma_p']})")
    if cfg.get("blur_p", 0):
        on.append(f"blur(p={cfg['blur_p']})")
    if cfg.get("noise_p", 0):
        on.append(f"noise(p={cfg['noise_p']})")
    if cfg.get("blur_p", 0) and cfg.get("noise_p", 0):
        on.append(f"order={cfg['blur_noise_order']}")
    return ", ".join(on) if on else "(all stages off)"
