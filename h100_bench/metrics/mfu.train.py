"""The training window's model FLOPs per second over the card's dense peak
for the step's dtype, in percent: the convs of every step in the traced
stretch (forward, input gradients where needed, weight gradients; a
rematerialized forward is not counted again) and of every validation
sweep's forward, counted on the reference network (h100_bench/reference),
over the stretch's length."""
from h100_bench.roofline import PEAK_FLOPS


def read(ctx):
    w, s = ctx["work"], ctx["summary"]
    if not w.get("steps") or not s["busy_s"] or s["window_s"] <= 0:
        return None
    flops = w["steps"] * w["step_flops"] + w["sweeps"] * w["sweep_flops"]
    return 100.0 * flops / (s["window_s"] * PEAK_FLOPS[w["dtype"]])
