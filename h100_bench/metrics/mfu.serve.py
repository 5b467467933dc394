"""The serving window's model FLOPs per second over the card's dense peak
for the model's dtype, in percent: the convs of every forward the traced
requests needed (every window, flip and fold), counted on the reference
network (h100_bench/reference), over the stretch's length."""
from h100_bench.roofline import PEAK_FLOPS


def read(ctx):
    w, s = ctx["work"], ctx["summary"]
    if not w.get("flops") or not s["busy_s"] or s["window_s"] <= 0:
        return None
    return 100.0 * w["flops"] / (s["window_s"] * PEAK_FLOPS[w["dtype"]])
