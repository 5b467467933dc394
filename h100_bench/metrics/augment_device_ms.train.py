"""Device milliseconds per training iteration of the kernels launched
inside ops/augment.py's ``augment_batch`` (the benchmark's
``bench.augment`` span) in the traced stretch."""


def read(ctx):
    seconds = ctx["summary"]["span_s"].get("bench.augment")
    steps = ctx["work"].get("steps")
    if not seconds or not steps:
        return None
    return 1e3 * seconds / steps
