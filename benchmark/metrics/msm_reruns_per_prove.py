"""Exact reruns of a commitment batch after a fold flag, a prove: the
program's counter `kzg.STATS["exact_reruns"]` over the window."""


def read(rec: dict):
    return rec["counters"]["exact_reruns"] / rec["num_proves"] if rec["num_proves"] else None
