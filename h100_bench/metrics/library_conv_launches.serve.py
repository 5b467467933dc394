"""Library convolution calls per served subject in the traced stretch: the
program's ``library_conv`` counter (ops/convolution.py, counted only while
the profiler runs) summed over its keys, over the subjects served. None
where the program keeps no such counter."""


def read(ctx):
    try:
        from segmentation_pipeline_torch.utils.timer import recorded
    except ImportError:
        return None
    calls = sum(recorded()["counters"].get("library_conv", {}).values())
    subjects = ctx["work"].get("subjects")
    if not calls or not subjects:
        return None
    return calls / subjects
