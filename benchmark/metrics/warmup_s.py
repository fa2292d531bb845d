"""Set-up's warm-up proves, seconds: the first builds the fixed-base MSM
table over the SRS."""


def read(rec: dict):
    return rec["setup"].get("warmup_s")
