"""The AHP prover's rounds, seconds a prove: the program's three
`AHP::Prover::*Round` spans (each synchronizes the card at both ends)."""


def read(rec: dict):
    total = sum(e - s for name, _, s, e in rec["spans"] if name.startswith("AHP::Prover::"))
    return total / rec["num_proves"] if total and rec["num_proves"] else None
