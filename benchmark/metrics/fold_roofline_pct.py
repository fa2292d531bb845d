"""Kernel 5, the bucket fold (`fold_kernel`): its least possible time over
its device time, in percent, over every fold of the traced window.  The
least time of a launch is the larger of its multiplies over the card's
integer peak and its bytes over the card's bandwidth, counted from the
fold's inputs by benchmark/roofline.py::fold_work; the device time is the
sum of the profiler's `fold_kernel` events."""


def read(rec: dict):
    fold = rec["fold"]
    if not fold["launches"] or fold["device_s"] <= 0:
        return None
    return 100.0 * fold["least_s"] / fold["device_s"]
