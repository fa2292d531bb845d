"""Circuit synthesis, seconds a prove: the benchmark's own host-clock timing
of its circuit's `generate_constraints` inside each prove of the window."""


def read(rec: dict):
    if not rec["synthesis"] or not rec["num_proves"]:
        return None
    return sum(e - s for s, e in rec["synthesis"]) / rec["num_proves"]
