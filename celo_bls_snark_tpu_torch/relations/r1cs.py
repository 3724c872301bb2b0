"""R1CS constraint system (the ark-relations equivalent).

The reference consumes `ark_relations::r1cs::ConstraintSystem` (SURVEY.md
layer 0); this module provides the same semantics for the gadget layer:

  - variables: One (instance 0), Instance(i), Witness(i)
  - linear combinations as sparse {variable: coeff} maps over the field
  - constraints a * b = c of LCs
  - setup vs prove mode (`is_in_setup_mode` drives the gadgets' native
    witness computation switch, crates/bls-gadgets/src/*.rs)
  - namespace stack for constraint attribution (the ConstraintLayer
    tracing equivalent, crates/bls-gadgets/src/utils.rs:56-78)
  - A/B/C matrix export for Groth16 and satisfaction checking
"""

from dataclasses import dataclass, field

import numpy as np


ONE = ("one", 0)


def instance_var(i):
    return ("x", i)


def witness_var(i):
    return ("w", i)


class LinearCombination:
    """Sparse coeff map over variables; immutable-ish value object."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms = dict(terms or {})

    @classmethod
    def from_var(cls, var, coeff=1):
        return cls({var: coeff})

    @classmethod
    def constant(cls, c):
        return cls({ONE: c}) if c else cls()

    @classmethod
    def _owned(cls, terms: dict):
        """Constructor that takes ownership of `terms` (no copy) — for the
        in-place accumulation fast paths."""
        lc = cls.__new__(cls)
        lc.terms = terms
        return lc

    def __add__(self, other):
        out = dict(self.terms)
        for v, c in other.terms.items():
            out[v] = out.get(v, 0) + c
            if out[v] == 0:
                del out[v]
        return LinearCombination(out)

    def add_scaled_(self, other, k):
        """In-place self += k * other. The O(1)-per-term accumulator the
        gadget hot loops (uint32.addmany, bit packing) use instead of the
        quadratic copy chain of repeated `lc = lc + term.scale(k)`."""
        t = self.terms
        for v, c in other.terms.items():
            nc = t.get(v, 0) + c * k
            if nc:
                t[v] = nc
            else:
                del t[v]
        return self

    def __sub__(self, other):
        return self + other.scale(-1)

    def scale(self, k):
        if k == 0:
            return LinearCombination()
        return LinearCombination({v: c * k for v, c in self.terms.items()})

    def is_zero(self):
        return not self.terms

    def __repr__(self):
        return f"LC({self.terms})"


@dataclass
class Constraint:
    a: LinearCombination
    b: LinearCombination
    c: LinearCombination
    trace: tuple = ()


class ConstraintSystem:
    """Modes: "setup" (no assignments) or "prove"."""

    def __init__(self, field_modulus: int, mode: str = "prove"):
        assert mode in ("setup", "prove")
        self.p = field_modulus
        self.mode = mode
        self.instance_assignment = [1]  # ONE
        self.witness_assignment = []
        self.num_instance = 1
        self.num_witness = 0
        self.constraints: list[Constraint] = []
        self._ns_stack: list[str] = []

    # --- mode -------------------------------------------------------------
    def is_in_setup_mode(self) -> bool:
        return self.mode == "setup"

    # --- namespaces (constraint attribution) -------------------------------
    class _Ns:
        def __init__(self, cs, name):
            self.cs = cs
            self.name = name

        def __enter__(self):
            self.cs._ns_stack.append(self.name)
            return self.cs

        def __exit__(self, *exc):
            self.cs._ns_stack.pop()

    def ns(self, name: str):
        return self._Ns(self, name)

    # --- variables ---------------------------------------------------------
    def new_instance_variable(self, value=None):
        if self.mode == "prove":
            assert value is not None, "instance needs a value in prove mode"
            self.instance_assignment.append(value % self.p)
        idx = self.num_instance
        self.num_instance += 1
        return instance_var(idx)

    def new_witness_variable(self, value=None):
        if self.mode == "prove":
            assert value is not None, "witness needs a value in prove mode"
            self.witness_assignment.append(value % self.p)
        idx = self.num_witness
        self.num_witness += 1
        return witness_var(idx)

    # --- constraints --------------------------------------------------------
    def enforce_constraint(self, a: LinearCombination, b: LinearCombination, c: LinearCombination):
        self.constraints.append(Constraint(a, b, c, tuple(self._ns_stack)))

    @property
    def num_constraints(self):
        return len(self.constraints)

    # --- evaluation ---------------------------------------------------------
    def assigned_value(self, var):
        kind, idx = var
        if kind == "one":
            return 1
        if kind == "x":
            return self.instance_assignment[idx]
        return self.witness_assignment[idx]

    def eval_lc(self, lc: LinearCombination) -> int:
        acc = 0
        for v, c in lc.terms.items():
            acc += c * self.assigned_value(v)
        return acc % self.p

    def is_satisfied(self) -> bool:
        return self.which_is_unsatisfied() is None

    def which_is_unsatisfied(self):
        """Returns the index + trace of the first violated constraint, or
        None (mirrors print_unsatisfied_constraints utility)."""
        assert self.mode == "prove"
        for i, con in enumerate(self.constraints):
            if self.eval_lc(con.a) * self.eval_lc(con.b) % self.p != self.eval_lc(con.c):
                return i, "/".join(con.trace)
        return None

    def constraint_counts_by_namespace(self):
        """ConstraintLayer-style attribution: namespace path -> count."""
        out = {}
        for con in self.constraints:
            key = "/".join(con.trace)
            out[key] = out.get(key, 0) + 1
        return out

    # --- matrices (for Groth16) ---------------------------------------------
    def _var_column(self, var):
        kind, idx = var
        if kind == "one":
            return 0
        if kind == "x":
            return idx
        return self.num_instance + idx

    def to_matrices(self):
        """Sparse A, B, C as lists of rows; each row is a list of
        (coeff, column) with columns ordered [instance | witness]."""
        mats = ([], [], [])
        for con in self.constraints:
            for m, lc in zip(mats, (con.a, con.b, con.c)):
                row = sorted(
                    ((c % self.p, self._var_column(v)) for v, c in lc.terms.items()),
                    key=lambda t: t[1],
                )
                m.append([t for t in row if t[0] != 0])
        return mats

    def to_csr(self):
        """A, B, C in CSR form, cached: each matrix is
        (indptr int64 [nc+1], cols int32 [nnz], coeffs object [nnz]).

        Unlike to_matrices (the canonical sorted form matrix_hash pins),
        term order within a row is unspecified and coefficients stay RAW
        (not reduced mod p — gadget coeffs are small, and keeping them
        small makes the object-array eval fast). This is the prover's
        evaluation form (groth16._compute_h, _qap_evals_at_tau)."""
        if getattr(self, "_csr", None) is not None and self._csr_nc == len(self.constraints):
            return self._csr
        ni = self.num_instance
        mats = []
        for which in range(3):
            indptr = np.empty(len(self.constraints) + 1, dtype=np.int64)
            indptr[0] = 0
            cols = []
            coeffs = []
            ap = cols.append
            cp = coeffs.append
            for j, con in enumerate(self.constraints):
                lc = (con.a, con.b, con.c)[which]
                for (kind, idx), c in lc.terms.items():
                    if kind == "w":
                        ap(ni + idx)
                    else:  # "one" has idx 0; "x" carries its index
                        ap(idx)
                    cp(c)
                indptr[j + 1] = len(cols)
            mats.append(
                (indptr, np.asarray(cols, dtype=np.int64),
                 np.asarray(coeffs, dtype=object))
            )
        self._csr = tuple(mats)
        self._csr_nc = len(self.constraints)
        return self._csr

    def eval_csr(self, csr_mat, z_obj):
        """One matrix's row evaluations M @ z mod p as an object array.
        z_obj: object array of the full assignment [instance | witness]."""
        indptr, cols, coeffs = csr_mat
        nc = len(indptr) - 1
        if len(cols) == 0:
            return np.zeros(nc, dtype=object)
        prod = coeffs * z_obj[cols]
        prod = np.append(prod, np.zeros(1, dtype=object))  # reduceat sentinel
        out = np.add.reduceat(prod, indptr[:-1])
        empty = indptr[1:] == indptr[:-1]
        if empty.any():
            out[empty] = 0
        return out % self.p

    def full_assignment_obj(self):
        """Full assignment as a numpy object array (for eval_csr)."""
        z = np.empty(self.num_instance + self.num_witness, dtype=object)
        z[: self.num_instance] = self.instance_assignment
        z[self.num_instance :] = self.witness_assignment
        return z

    def evaluate_abc(self):
        """(A@z, B@z, C@z) mod p as object arrays — the shared input of the
        satisfaction check and the prover's QAP evaluation."""
        csr = self.to_csr()
        z = self.full_assignment_obj()
        return tuple(self.eval_csr(m, z) for m in csr)

    def which_is_unsatisfied_from_evals(self, a_e, b_e, c_e):
        """First violated constraint index + trace from evaluate_abc()
        output, or None — which_is_unsatisfied without re-evaluating."""
        bad = np.nonzero((a_e * b_e - c_e) % self.p)[0]
        if len(bad) == 0:
            return None
        i = int(bad[0])
        return i, "/".join(self.constraints[i].trace)

    def full_assignment(self):
        return list(self.instance_assignment) + list(self.witness_assignment)
