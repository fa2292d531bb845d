"""The prove's own host work around its phases, seconds a prove:
`Marlin::Prover` less its phase spans (depth 1, the benchmark's opening
span among them) and less synthesis.  What is left: finalizing and
squaring the constraint system, the witness's transfer and sparse
products, the Fiat-Shamir transcript, the evaluation prefetch and the
building of the linear combinations."""


def read(rec: dict):
    prover = sum(e - s for name, depth, s, e in rec["spans"] if depth == 0 and name == "Marlin::Prover")
    if not prover or not rec["num_proves"]:
        return None
    phases = sum(e - s for _, depth, s, e in rec["spans"] if depth == 1)
    synthesis = sum(e - s for s, e in rec["synthesis"])
    return (prover - phases - synthesis) / rec["num_proves"]
