"""Finalizing the prove's constraint system, seconds a prove: the program's
`R1CS::finalize` span inside `Marlin::Prover` (padding the input, the Weight
goal's inlining and outlining of the symbolic LCs, squaring the matrices).
A program without the span reads nothing."""


def read(rec: dict):
    total = sum(e - s for name, _, s, e in rec["spans"] if name == "R1CS::finalize")
    return total / rec["num_proves"] if total and rec["num_proves"] else None
