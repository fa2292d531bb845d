"""The commitment scheme, seconds a prove: the program's three
`Committing to ... round polys` spans and the benchmark's span around the
scheme's opening (`PC.open_combinations`: combining the linear
combinations, the witness polynomials and their MSMs, the blinding)."""

SPANS = ("Committing to first round polys", "Committing to second round polys",
         "Committing to third round polys", "Opening the linear combinations (benchmark)")


def read(rec: dict):
    total = sum(e - s for name, _, s, e in rec["spans"] if name in SPANS)
    return total / rec["num_proves"] if total and rec["num_proves"] else None
