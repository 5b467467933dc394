"""The share of the traced stretch of a serving window in which no
operation ran on the card (kernels, copies and fills merged), in percent."""


def read(ctx):
    s = ctx["summary"]
    if not s["busy_s"] or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
