"""The card's idle share of the traced window, in percent: 100 times one
less the union of the profiler's device operations over the window's
length."""


def read(rec: dict):
    w0, w1 = rec["window"]
    if rec["busy_s"] <= 0 or w1 <= w0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / (w1 - w0))
