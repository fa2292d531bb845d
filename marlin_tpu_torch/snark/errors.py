"""Unified error surface (reference src/error.rs:5-12, src/ahp/mod.rs:269-287).

The reference's `Error<E>` enum has three arms — `IndexTooLarge`,
`AHPError(..)`, and `PolynomialCommitmentError(E)` — and every public entry
point returns it.  The Python analog is an exception hierarchy rooted at
:class:`MarlinError`: callers can catch the root to handle any framework
failure, or a specific subtree (AHP vs PC) exactly as the reference's arms
allow matching.  Module-level aliases in indexer/prover/verifier/lc/kzg
keep their historical names as subclasses.
"""

from __future__ import annotations


class MarlinError(Exception):
    """Root of the framework's error hierarchy (Error<E> analog)."""


class IndexTooLargeError(MarlinError):
    """The circuit exceeds the universal SRS (Error::IndexTooLarge)."""


class AHPError(MarlinError):
    """Information-theoretic layer failures (Error::AHPError; sub-errors at
    reference src/ahp/mod.rs:269-287)."""


class PolynomialCommitmentError(MarlinError):
    """Crypto-layer failures (Error::PolynomialCommitmentError(E))."""
