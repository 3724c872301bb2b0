"""Constraint-matrix fingerprinting — the regression guard of
crates/epoch-snark/src/gadgets/epochs.rs:592-597 (expected_matrices_hashes):
any unintended change to the circuit's A/B/C matrices (reordered
allocations, different constraint shapes) changes these digests.

The reference's own hex values are compat-feature hashes of ark's matrix
serialization; this build's circuit is intentionally leaner (see
ROADMAP.md), so the pinned digests here fingerprint THIS circuit — the
guard is against accidental drift, not ark byte-parity.
"""

import hashlib


def matrices_hashes(cs):
    """blake2s-256 hex digest per matrix (A, B, C) of the given synthesized
    ConstraintSystem. Serialization: u64-LE row count, then per row a
    u64-LE entry count and (coeff 96-byte LE, column u64-LE) entries,
    columns ordered [instance | witness]."""
    out = []
    for m in cs.to_matrices():
        h = hashlib.blake2s()
        h.update(len(m).to_bytes(8, "little"))
        for row in m:
            h.update(len(row).to_bytes(8, "little"))
            for coeff, col in row:
                h.update(int(coeff).to_bytes(96, "little"))
                h.update(int(col).to_bytes(8, "little"))
        out.append(h.hexdigest())
    return out
