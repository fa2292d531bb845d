"""Keys, proof, and transcript/byte codecs (reference src/data_structures.rs).

Byte layouts follow the arkworks `ToBytes` conventions the FS transcript
depends on (SURVEY.md §7 "bit-exact transcript" note): little-endian field
reprs, u64 counters, points as x||y||infinity-byte, Option as 1-byte flag.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fields import active as P
from ..fields import host_curve as hc
from ..fields import host_field as hf
from .indexer import Index, IndexInfo
from .kzg import BatchLCProof, Commitment, CommitterKey, Randomness, VerifierKey

R = P.R_MODULUS


def commitment_to_bytes(c: Commitment) -> bytes:
    """marlin_pc Commitment ToBytes: comm, then Option<shifted_comm>."""
    out = hc.g1_to_bytes(c.comm)
    if c.shifted_comm is None:
        out += b"\x00"
    else:
        out += b"\x01" + hc.g1_to_bytes(c.shifted_comm)
    return out


def field_vec_to_bytes(vals: list) -> bytes:
    return b"".join(hf.fr_to_bytes(v) for v in vals)


@dataclass
class IndexVerifierKey:
    """Reference src/data_structures.rs:26-62."""

    index_info: IndexInfo
    index_comms: list  # [6] Commitment in INDEXER_POLYNOMIALS order
    verifier_key: VerifierKey

    def to_bytes(self) -> bytes:
        """Transcript encoding (reference data_structures.rs:36-43)."""
        out = self.index_info.to_bytes()
        for c in self.index_comms:
            out += commitment_to_bytes(c)
        return out


@dataclass
class IndexProverKey:
    """Reference src/data_structures.rs:70-79."""

    index_vk: IndexVerifierKey
    index_comm_rands: list  # [6] Randomness
    index: Index
    committer_key: CommitterKey


@dataclass
class Proof:
    """Reference src/data_structures.rs:101-110."""

    commitments: list  # [3] lists of Commitment (per round)
    evaluations: list  # label-sorted ints (zero-eval LCs excluded)
    prover_messages: list  # [3] lists of field elements (always empty in Marlin)
    pc_proof: BatchLCProof

    def serialized_size(self) -> int:
        return len(self.to_bytes())

    def to_bytes(self) -> bytes:
        """Compressed proof encoding (arkworks CanonicalSerialize layout:
        length-prefixed vectors, compressed points)."""
        out = hf.u64_to_bytes(len(self.commitments))
        for round_comms in self.commitments:
            out += hf.u64_to_bytes(len(round_comms))
            for c in round_comms:
                out += hc.g1_compress(c.comm)
                out += b"\x01" + hc.g1_compress(c.shifted_comm) if c.shifted_comm else b"\x00"
        out += hf.u64_to_bytes(len(self.evaluations))
        out += field_vec_to_bytes(self.evaluations)
        out += hf.u64_to_bytes(len(self.prover_messages))
        for msg in self.prover_messages:
            if msg:
                out += b"\x01" + hf.u64_to_bytes(len(msg)) + field_vec_to_bytes(msg)
            else:
                out += b"\x00"
        out += hf.u64_to_bytes(len(self.pc_proof.proofs))
        for pp in self.pc_proof.proofs:
            out += hc.g1_compress(pp.w)
            if pp.random_v is None:
                out += b"\x00"
            else:
                out += b"\x01" + hf.fr_to_bytes(pp.random_v)
        # BatchLCProof.evals: Option<Vec<F>> (ark-poly-commit; None from
        # open_combinations) — serialized as a 1-byte Option flag
        if self.pc_proof.evals is None:
            out += b"\x00"
        else:
            out += (
                b"\x01"
                + hf.u64_to_bytes(len(self.pc_proof.evals))
                + field_vec_to_bytes(self.pc_proof.evals)
            )
        return out

    @staticmethod
    def from_bytes(data: bytes) -> "Proof":
        """Inverse of to_bytes (proof interchange / checkpoint)."""
        from .kzg import BatchLCProof, Commitment, PointProof

        off = 0

        def take(n):
            """Strict slice: truncated input raises instead of silently
            misparsing (ark CanonicalDeserialize errors the same way)."""
            nonlocal off
            if off + n > len(data):
                raise ValueError("truncated proof bytes")
            chunk = data[off : off + n]
            off += n
            return chunk

        def u64(cap=1 << 20):
            v = int.from_bytes(take(8), "little")
            if v > cap:
                raise ValueError("implausible length prefix in proof bytes")
            return v

        def flag_byte():
            b = take(1)[0]
            if b > 1:
                raise ValueError("invalid Option flag in proof bytes")
            return b

        def point():
            return hc.g1_decompress(take(P.FQ_BYTES))

        def fr():
            v = hf.fr_from_bytes(take(P.FR_BYTES))
            if v >= R:
                raise ValueError("field element out of range")
            return v

        commitments = []
        for _ in range(u64()):
            row = []
            for _ in range(u64()):
                comm = point()
                shifted = point() if flag_byte() else None
                row.append(Commitment(comm=comm, shifted_comm=shifted))
            commitments.append(row)
        evaluations = [fr() for _ in range(u64())]
        prover_messages = []
        for _ in range(u64()):
            if flag_byte():
                prover_messages.append([fr() for _ in range(u64())])
            else:
                prover_messages.append([])
        proofs = []
        for _ in range(u64()):
            w = point()
            rv = fr() if flag_byte() else None
            proofs.append(PointProof(w=w, random_v=rv))
        lc_evals = [fr() for _ in range(u64())] if flag_byte() else None
        if off != len(data):
            raise ValueError("trailing bytes after proof")
        return Proof(
            commitments=commitments,
            evaluations=evaluations,
            prover_messages=prover_messages,
            pc_proof=BatchLCProof(proofs=proofs, evals=lc_evals),
        )

    def print_size_info(self) -> dict:
        """Proof-size statistics with per-class byte accounting
        (reference data_structures.rs:129-187)."""
        num_plain = num_bounded = bytes_plain = bytes_bounded = 0
        for rc in self.commitments:
            for c in rc:
                # marlin_pc Commitment serialized size: comm + Option flag
                # (+ shifted comm); sonic commitments have no shifted slot
                sz = P.FQ_BYTES + 1
                if c.shifted_comm is not None:
                    num_bounded += 1
                    bytes_bounded += sz + P.FQ_BYTES
                else:
                    num_plain += 1
                    bytes_plain += sz
        bytes_proofs = 8 + sum(
            P.FQ_BYTES + 1 + (P.FR_BYTES if pp.random_v is not None else 0)
            for pp in self.pc_proof.proofs
        )
        num_msg_elems = sum(len(m) for m in self.prover_messages)
        stats = {
            "argument_size_bytes": self.serialized_size(),
            "num_comms_without_degree_bounds": num_plain,
            "size_bytes_comms_without_degree_bounds": bytes_plain,
            "num_comms_with_degree_bounds": num_bounded,
            "size_bytes_comms_with_degree_bounds": bytes_bounded,
            "num_evaluations": len(self.evaluations),
            "size_bytes_evaluations": 8 + P.FR_BYTES * len(self.evaluations),
            "num_opening_proofs": len(self.pc_proof.proofs),
            "size_bytes_proofs": bytes_proofs,
            "num_prover_message_elements": num_msg_elems,
        }
        return stats
