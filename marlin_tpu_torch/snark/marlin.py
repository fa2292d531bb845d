"""The Marlin driver: universal_setup / index / prove / verify.

Port of `marlin_tpu/snark/marlin.py`: `Marlin` over MarlinKZG10 and
`MarlinSonic` over the Sonic-style PC (snark/sonic.py).  Every entry point takes a `device`: None means
the card ("cuda"), and a machine without one raises unless the caller asks
for "cpu".  Keys carry the device their tensors live on, and an entry point
given keys on another device raises instead of moving them.
"""

from __future__ import annotations

import torch

from ..fields import active as P
from ..utils import profiling
from ..utils.rand import ZkRng
from . import ahp, kzg, lc as lc_mod, prover as prover_mod, sonic, verifier as verifier_mod
from .data_structures import (
    IndexProverKey,
    IndexVerifierKey,
    Proof,
    commitment_to_bytes,
    field_vec_to_bytes,
)
from .domains import new_domain
from .errors import IndexTooLargeError, MarlinError
from .fs import FiatShamirRng
from .indexer import index_circuit
from .prover import LabeledPoly

R = P.R_MODULUS

PROTOCOL_NAME = b"MARLIN-2019"  # reference src/lib.rs:75


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another; raises when that device is a GPU this machine does not have."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "marlin_tpu_torch runs on a CUDA device and none is available; "
            'pass device="cpu" to run the plain versions on the CPU'
        )
    return dev


def _same_device(have: torch.device, want: torch.device, what: str) -> None:
    if have.type != want.type or (
        want.index is not None and have.index is not None and have.index != want.index
    ):
        raise ValueError(f"{what} lives on {have}, but the call asked for {want}")


def _prefetch_evaluations(provider, polys, plan) -> None:
    """Populate the provider's (label, point) cache with batched kernels."""
    from ..ops import fr, poly as poly_ops

    for point, labels in plan:
        arrs = [polys[l].coeffs for l in labels]
        max_len = max(a.shape[0] for a in arrs)
        stacked = torch.stack([poly_ops.pad_to(a, max_len) for a in arrs])
        z = fr.from_int(point, stacked.device)
        vals = fr.to_ints(poly_ops.evaluate_batch(stacked, z))
        for l, v in zip(labels, vals):
            provider._cache[(l, point)] = v


class Marlin:
    """Marlin<Fr, MarlinKZG10, SimpleHashFiatShamirRng<Blake2s, ChaCha>>.

    The polynomial-commitment scheme is the `PC` class attribute (the
    reference's `Marlin<F, PC, FS>` generics, src/lib.rs:64)."""

    PC = kzg

    # ---- setup -------------------------------------------------------------

    @classmethod
    def universal_setup(
        cls,
        num_constraints: int,
        num_variables: int,
        num_non_zero: int,
        rng: ZkRng,
        device=None,
    ) -> kzg.UniversalParams:
        """Reference src/lib.rs:79-96."""
        dev = resolve_device(device)
        max_degree = ahp.max_degree(num_constraints, num_variables, num_non_zero)
        with profiling.span(f"Marlin::UniversalSetup with max_degree {max_degree}"):
            return cls.PC.setup(max_degree, rng, dev)

    # ---- index -------------------------------------------------------------

    @classmethod
    def index(cls, srs: kzg.UniversalParams, circuit, device=None):
        """Reference src/lib.rs:100-148."""
        dev = resolve_device(device)
        _same_device(srs.device, dev, "the SRS")
        with profiling.span("Marlin::Index"):
            index = index_circuit(circuit, srs.device)
            if srs.max_degree() < index.max_degree():
                raise IndexTooLargeError("IndexTooLarge: circuit needs a larger SRS")

            coeff_support = ahp.get_degree_bounds(index.index_info)
            supported_hiding_bound = 1  # reference src/lib.rs:114
            ck, vk = cls.PC.trim(srs, index.max_degree(), supported_hiding_bound, coeff_support)

            with profiling.span("Commit to index polynomials"):
                labeled = [
                    LabeledPoly(label, coeffs, bound, None)
                    for label, coeffs, bound in index.iter_polys()
                ]
                index_comms, index_rands = cls.PC.commit(ck, labeled, None)

            index_vk = IndexVerifierKey(
                index_info=index.index_info, index_comms=index_comms, verifier_key=vk
            )
            index_pk = IndexProverKey(
                index_vk=index_vk,
                index_comm_rands=index_rands,
                index=index,
                committer_key=ck,
            )
            return index_pk, index_vk

    # ---- prove -------------------------------------------------------------

    @classmethod
    def prove(
        cls, index_pk: IndexProverKey, circuit, zk_rng: ZkRng, device=None, mesh=None
    ) -> Proof:
        """Reference src/lib.rs:151-311.

        With `mesh` (a `parallel.multihost.Mesh` whose devices are all of
        `device`'s type), every round NTT and commit MSM large enough runs
        sharded over the mesh's devices (the four-step NTT and the
        distributed Pippenger, marlin_tpu/snark/marlin.py:114-128); the
        proof bytes are the single-device ones.  A mesh spanning processes
        (`multihost.make_mesh` after `init_distributed`) takes the same
        call on every rank, with the same keys, circuit and rng state, and
        every rank returns the same proof; without the process group it is
        refused."""
        dev = resolve_device(device)
        _same_device(index_pk.index.device, dev, "the proving key")
        if mesh is not None:
            from ..parallel.context import use_mesh
            from ..parallel.multihost import require_device_type

            require_device_type(mesh.devices.flat, dev, "a prove")
            with use_mesh(mesh):
                return cls.prove(index_pk, circuit, zk_rng, device)
        with profiling.span("Marlin::Prover"):
            state = prover_mod.prover_init(index_pk.index, circuit)
            public_input = state.public_input()

            fs = FiatShamirRng(
                PROTOCOL_NAME + index_pk.index_vk.to_bytes() + field_vec_to_bytes(public_input)
            )

            ck = index_pk.committer_key

            # --- round 1 ---
            with profiling.span("AHP::Prover::FirstRound"):
                first_oracles, state = prover_mod.prover_first_round(state, zk_rng)
            with profiling.span("Committing to first round polys"):
                first_list = [first_oracles[l] for l in ["w", "z_a", "z_b", "mask_poly"]]
                first_comms, first_rands = cls.PC.commit(ck, first_list, zk_rng)
            fs.absorb(b"".join(commitment_to_bytes(c) for c in first_comms))
            ver_first, ver_state = verifier_mod.verifier_first_round(
                index_pk.index_vk.index_info, fs
            )

            # --- round 2 ---
            with profiling.span("AHP::Prover::SecondRound"):
                second_oracles, state = prover_mod.prover_second_round(ver_first, state, zk_rng)
            with profiling.span("Committing to second round polys"):
                second_list = [second_oracles[l] for l in ["t", "g_1", "h_1"]]
                second_comms, second_rands = cls.PC.commit(ck, second_list, zk_rng)
            fs.absorb(b"".join(commitment_to_bytes(c) for c in second_comms))
            ver_second, ver_state = verifier_mod.verifier_second_round(ver_state, fs)

            # --- round 3 ---
            with profiling.span("AHP::Prover::ThirdRound"):
                third_oracles = prover_mod.prover_third_round(ver_second, state, zk_rng)
            with profiling.span("Committing to third round polys"):
                third_list = [third_oracles[l] for l in ["g_2", "h_2"]]
                third_comms, third_rands = cls.PC.commit(ck, third_list, zk_rng)
            fs.absorb(b"".join(commitment_to_bytes(c) for c in third_comms))
            ver_state = verifier_mod.verifier_third_round(ver_state, fs)

            # --- gather oracles ---
            polys: dict = {}
            rands: dict = {}
            for (label, coeffs, bound), r in zip(
                index_pk.index.iter_polys(), index_pk.index_comm_rands
            ):
                polys[label] = LabeledPoly(label, coeffs, bound, None)
                rands[label] = r
            for oracles, rs, order in (
                (first_oracles, first_rands, ["w", "z_a", "z_b", "mask_poly"]),
                (second_oracles, second_rands, ["t", "g_1", "h_1"]),
                (third_oracles, third_rands, ["g_2", "h_2"]),
            ):
                for label, r in zip(order, rs):
                    polys[label] = oracles[label]
                    rands[label] = r

            query_set, ver_state = verifier_mod.verifier_query_set(ver_state)
            provider = lc_mod.PolyEvaluationsProvider(polys)
            # all needed oracle evaluations in two batched evaluations (one
            # per query point) and a single host transfer each
            beta = ver_state.second_round_msg.beta
            gamma = ver_state.gamma
            _prefetch_evaluations(
                provider,
                polys,
                [
                    (beta, ["g_1", "h_1", "mask_poly", "t", "w", "z_a", "z_b"]),
                    (gamma, ["a_val", "b_val", "c_val", "col", "g_2", "h_2", "row", "row_col"]),
                ],
            )
            lc_s = lc_mod.construct_linear_combinations(public_input, provider, ver_state)

            with profiling.span("Evaluating linear combinations over query set"):
                evaluations = []
                for label, (_pl, point) in query_set:
                    the_lc = next((l for l in lc_s if l.label == label), None)
                    if the_lc is None:
                        raise MarlinError(f"missing LC {label}")
                    ev = provider.get_lc_eval(the_lc, point)
                    if label not in ahp.LC_WITH_ZERO_EVAL:
                        evaluations.append((label, ev))
                evaluations.sort(key=lambda t: t[0])
                eval_values = [v for _, v in evaluations]

            fs.absorb(field_vec_to_bytes(eval_values))
            opening_challenge = fs.rand_u128() % R  # reference src/lib.rs:290

            pc_proof = cls.PC.open_combinations(
                ck, lc_s, polys, rands, query_set, opening_challenge
            )

            proof = Proof(
                commitments=[first_comms, second_comms, third_comms],
                evaluations=eval_values,
                prover_messages=[[], [], []],
                pc_proof=pc_proof,
            )
            if profiling.is_enabled():
                print(proof.print_size_info(), flush=True)
            return proof

    # ---- verify ------------------------------------------------------------

    @classmethod
    def verify(
        cls,
        index_vk: IndexVerifierKey,
        public_input: list,
        proof: Proof,
        rng: ZkRng,
        device=None,
    ) -> bool:
        """Reference src/lib.rs:315-433.  The verifier is succinct and runs on
        the host; `device` follows the same rule as the other entry points.

        Malformed proofs (wrong shapes, off-curve/out-of-subgroup points,
        out-of-range scalars) return False rather than raising."""
        resolve_device(device)
        try:
            return cls._verify_inner(index_vk, public_input, proof, rng)
        except (
            ValueError,
            KeyError,
            IndexError,
            AssertionError,
            kzg.PCError,
            verifier_mod.VerifierError,
            lc_mod.LcError,
        ):
            return False

    @classmethod
    def _verify_inner(
        cls, index_vk: IndexVerifierKey, public_input: list, proof: Proof, rng: ZkRng
    ) -> bool:
        with profiling.span("Marlin::Verify"):
            # structural shape of a Marlin proof: 3 rounds of [4, 3, 2]
            # commitments and one batched opening per query point
            if [len(r) for r in proof.commitments] != [4, 3, 2]:
                return False
            if len(proof.prover_messages) != 3 or any(proof.prover_messages):
                return False
            if len(proof.pc_proof.proofs) != 2:
                return False

            # re-pad the input like the prover's formatted input (lib.rs:323-333)
            domain_x = new_domain(len(public_input) + 1)
            padded_input = list(public_input) + [0] * (
                max(len(public_input), domain_x.size - 1) - len(public_input)
            )

            fs = FiatShamirRng(
                PROTOCOL_NAME + index_vk.to_bytes() + field_vec_to_bytes(padded_input)
            )

            first_comms, second_comms, third_comms = proof.commitments
            fs.absorb(b"".join(commitment_to_bytes(c) for c in first_comms))
            try:
                ver_first, ver_state = verifier_mod.verifier_first_round(
                    index_vk.index_info, fs
                )
            except verifier_mod.VerifierError:
                return False
            fs.absorb(b"".join(commitment_to_bytes(c) for c in second_comms))
            ver_second, ver_state = verifier_mod.verifier_second_round(ver_state, fs)
            fs.absorb(b"".join(commitment_to_bytes(c) for c in third_comms))
            ver_state = verifier_mod.verifier_third_round(ver_state, fs)

            info = index_vk.index_info
            degree_bounds = (
                [None] * len(index_vk.index_comms)
                + ahp.first_round_degree_bounds(info)
                + ahp.second_round_degree_bounds(info)
                + ahp.third_round_degree_bounds(info)
            )
            all_comms = list(index_vk.index_comms) + first_comms + second_comms + third_comms
            labeled_comms = {
                label: kzg.LabeledCommitment(label, c, b)
                for label, c, b in zip(ahp.polynomial_labels(), all_comms, degree_bounds)
            }

            query_set, ver_state = verifier_mod.verifier_query_set(ver_state)

            fs.absorb(field_vec_to_bytes(proof.evaluations))
            opening_challenge = fs.rand_u128() % R

            evaluations = {}
            labels_needing_evals = []
            for label, (_pl, point) in query_set:
                if label in ahp.LC_WITH_ZERO_EVAL:
                    evaluations[(label, point)] = 0
                else:
                    labels_needing_evals.append((label, point))
            labels_needing_evals.sort(key=lambda t: t[0])
            if len(labels_needing_evals) != len(proof.evaluations):
                return False
            for (label, point), v in zip(labels_needing_evals, proof.evaluations):
                evaluations[(label, point)] = v % R

            provider = lc_mod.MapEvaluationsProvider(evaluations)
            try:
                lc_s = lc_mod.construct_linear_combinations(padded_input, provider, ver_state)
            except lc_mod.LcError:
                return False

            return cls.PC.check_combinations(
                index_vk.verifier_key,
                lc_s,
                labeled_comms,
                query_set,
                evaluations,
                proof.pc_proof,
                opening_challenge,
                rng,
            )


class MarlinSonic(Marlin):
    """Marlin over the Sonic-style PC (reference benches/bench.rs:79-84)."""

    PC = sonic
