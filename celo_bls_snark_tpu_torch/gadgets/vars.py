"""R1CS variable gadgets: Boolean and FpVar over a native prime field.

The ark-r1cs-std equivalents the reference's gadget layer is built on
(crates/bls-gadgets/* all consume FpVar/Boolean/G1Var/G2Var). Costs follow
ark-r1cs-std 0.3 structure:
  - Boolean witness allocation: 1 booleanity constraint
  - and/or/xor: 1 constraint; not: free
  - FpVar add/sub/neg/constant-mul: free (linear-combination algebra)
  - FpVar mul/square/inverse: 1 constraint
  - to_bits_le: MODULUS_BITS booleanity + 1 packing + in-field check
  - cmp chains via the 2*(b-a) LSB-parity trick
"""

from ..relations.r1cs import ConstraintSystem, LinearCombination, ONE


class Boolean:
    """Either a constant bool or an allocated/derived bit."""

    def __init__(self, cs, lc, value, constant=None):
        self.cs = cs
        self._lc = lc  # LinearCombination (0/1-valued)
        self.value = value  # bool | None (setup)
        self.constant = constant  # bool if compile-time constant

    # --- constructors -----------------------------------------------------
    @classmethod
    def true(cls, cs):
        return cls(cs, LinearCombination.constant(1), True, constant=True)

    @classmethod
    def false(cls, cs):
        return cls(cs, LinearCombination(), False, constant=False)

    @classmethod
    def const(cls, cs, b: bool):
        return cls.true(cs) if b else cls.false(cs)

    @classmethod
    def new_witness(cls, cs: ConstraintSystem, value):
        if cs.is_in_setup_mode():
            v, var = None, cs._setup_witness()
        else:
            v = bool(value)
            var = cs.new_witness_variable(1 if v else 0)
        lc = LinearCombination.from_var(var)
        # booleanity: b * (1 - b) = 0
        cs.enforce_constraint(lc, LinearCombination.constant(1) - lc, LinearCombination())
        return cls(cs, lc, v)

    @classmethod
    def new_input(cls, cs: ConstraintSystem, value):
        if cs.is_in_setup_mode():
            v, var = None, cs._setup_instance()
        else:
            v = bool(value)
            var = cs.new_instance_variable(1 if v else 0)
        lc = LinearCombination.from_var(var)
        cs.enforce_constraint(lc, LinearCombination.constant(1) - lc, LinearCombination())
        return cls(cs, lc, v)

    # --- accessors --------------------------------------------------------
    def lc(self) -> LinearCombination:
        return self._lc

    def is_constant(self):
        return self.constant is not None

    # --- logic ------------------------------------------------------------
    def not_(self):
        if self.is_constant():
            return Boolean.const(self.cs, not self.constant)
        return Boolean(
            self.cs,
            LinearCombination.constant(1) - self._lc,
            None if self.value is None else (not self.value),
        )

    def and_(self, other):
        cs = self.cs
        if self.is_constant():
            return other if self.constant else Boolean.false(cs)
        if other.is_constant():
            return self if other.constant else Boolean.false(cs)
        val = None if self.value is None or other.value is None else (self.value and other.value)
        out = Boolean.new_witness_unchecked(cs, val)
        # a * b = c
        cs.enforce_constraint(self._lc, other._lc, out._lc)
        return out

    def or_(self, other):
        # a | b = !( !a & !b )
        return self.not_().and_(other.not_()).not_()

    def xor(self, other):
        cs = self.cs
        if self.is_constant():
            return other if not self.constant else other.not_()
        if other.is_constant():
            return self if not other.constant else self.not_()
        val = None if self.value is None or other.value is None else (self.value ^ other.value)
        out = Boolean.new_witness_unchecked(cs, val)
        # 2a * b = a + b - c
        cs.enforce_constraint(
            self._lc.scale(2), other._lc, self._lc + other._lc - out._lc
        )
        return out

    @classmethod
    def new_witness_unchecked(cls, cs, value):
        """Allocate a bit variable WITHOUT a booleanity constraint (used for
        derived values already constrained to be boolean)."""
        if cs.is_in_setup_mode():
            var = cs._setup_witness()
            return cls(cs, LinearCombination.from_var(var), None)
        var = cs.new_witness_variable(1 if value else 0)
        return cls(cs, LinearCombination.from_var(var), bool(value))

    @staticmethod
    def kary_and(bits):
        """AND of k bits: k-1 constraints (pairwise chain)."""
        assert bits
        out = bits[0]
        for b in bits[1:]:
            out = out.and_(b)
        return out

    def select(self, t, f):
        """self ? t : f for Boolean operands (1 constraint)."""
        cs = self.cs
        if self.is_constant():
            return t if self.constant else f
        val = None
        if self.value is not None and t.value is not None and f.value is not None:
            val = t.value if self.value else f.value
        out = Boolean.new_witness_unchecked(cs, val)
        # c * (t - f) = out - f
        cs.enforce_constraint(self._lc, t._lc - f._lc, out._lc - f._lc)
        return out


# convenience: setup-mode allocation helpers on ConstraintSystem
def _setup_witness(cs):
    idx = cs.num_witness
    cs.num_witness += 1
    from ..relations.r1cs import witness_var

    return witness_var(idx)


def _setup_instance(cs):
    idx = cs.num_instance
    cs.num_instance += 1
    from ..relations.r1cs import instance_var

    return instance_var(idx)


ConstraintSystem._setup_witness = _setup_witness
ConstraintSystem._setup_instance = _setup_instance


class FpVar:
    """A native-field variable: symbolic LC + (prove-mode) value."""

    def __init__(self, cs, lc, value, constant=None):
        self.cs = cs
        self.lc = lc
        self.value = value  # int | None
        self.constant = constant  # int if compile-time constant

    # --- constructors -----------------------------------------------------
    @classmethod
    def const(cls, cs, v: int):
        v = v % cs.p
        return cls(cs, LinearCombination.constant(v), v, constant=v)

    @classmethod
    def new_witness(cls, cs, value):
        if cs.is_in_setup_mode():
            var = cs._setup_witness()
            return cls(cs, LinearCombination.from_var(var), None)
        v = int(value) % cs.p
        var = cs.new_witness_variable(v)
        return cls(cs, LinearCombination.from_var(var), v)

    @classmethod
    def new_input(cls, cs, value):
        if cs.is_in_setup_mode():
            var = cs._setup_instance()
            return cls(cs, LinearCombination.from_var(var), None)
        v = value % cs.p
        var = cs.new_instance_variable(v)
        return cls(cs, LinearCombination.from_var(var), v)

    def is_constant(self):
        return self.constant is not None

    # --- linear ops (free) ------------------------------------------------
    def add(self, other):
        val = None
        if self.value is not None and other.value is not None:
            val = (self.value + other.value) % self.cs.p
        const = None
        if self.is_constant() and other.is_constant():
            const = val
        return FpVar(self.cs, self.lc + other.lc, val, const)

    def sub(self, other):
        val = None
        if self.value is not None and other.value is not None:
            val = (self.value - other.value) % self.cs.p
        const = None
        if self.is_constant() and other.is_constant():
            const = val
        return FpVar(self.cs, self.lc - other.lc, val, const)

    def neg(self):
        val = None if self.value is None else (-self.value) % self.cs.p
        const = val if self.is_constant() else None
        return FpVar(self.cs, self.lc.scale(-1), val, const)

    def mul_const(self, k: int):
        k = k % self.cs.p
        val = None if self.value is None else self.value * k % self.cs.p
        const = val if self.is_constant() else None
        return FpVar(self.cs, self.lc.scale(k), val, const)

    # --- multiplicative ops (1 constraint) --------------------------------
    def mul(self, other):
        cs = self.cs
        if self.is_constant():
            return other.mul_const(self.constant)
        if other.is_constant():
            return self.mul_const(other.constant)
        val = None
        if self.value is not None and other.value is not None:
            val = self.value * other.value % cs.p
        out = FpVar.new_witness(cs, 0 if val is None else val)
        cs.enforce_constraint(self.lc, other.lc, out.lc)
        return out

    def square(self):
        return self.mul(self)

    def inverse(self):
        """1 constraint: self * inv = 1 (fails to satisfy if self == 0)."""
        cs = self.cs
        if self.is_constant():
            return FpVar.const(cs, pow(self.constant, -1, cs.p))
        val = None
        if self.value is not None:
            val = pow(self.value, -1, cs.p) if self.value != 0 else 0
        inv = FpVar.new_witness(cs, 0 if val is None else val)
        cs.enforce_constraint(self.lc, inv.lc, LinearCombination.constant(1))
        return inv

    def mul_by_inverse(self, other):
        """self / other (2 constraints like ark's mul_by_inverse)."""
        return self.mul(other.inverse())

    # --- selections / equality --------------------------------------------
    @staticmethod
    def conditionally_select(cond: Boolean, t: "FpVar", f: "FpVar"):
        cs = t.cs
        if cond.is_constant():
            return t if cond.constant else f
        val = None
        if cond.value is not None and t.value is not None and f.value is not None:
            val = t.value if cond.value else f.value
        out = FpVar.new_witness(cs, 0 if val is None else val)
        # cond * (t - f) = out - f
        cs.enforce_constraint(cond.lc(), t.lc - f.lc, out.lc - f.lc)
        return out

    def enforce_equal(self, other):
        self.cs.enforce_constraint(
            self.lc - other.lc, LinearCombination.constant(1), LinearCombination()
        )

    def conditional_enforce_equal(self, other, cond: Boolean):
        # cond * (a - b) = 0
        self.cs.enforce_constraint(cond.lc(), self.lc - other.lc, LinearCombination())

    def conditional_enforce_not_equal(self, other, cond: Boolean):
        """cond => a != b: (a-b) * multiplier = cond (1 constraint + 1 wit)."""
        cs = self.cs
        val = None
        if self.value is not None and other.value is not None and cond.value is not None:
            d = (self.value - other.value) % cs.p
            val = pow(d, -1, cs.p) if d != 0 and cond.value else 0
        m = FpVar.new_witness(cs, 0 if val is None else val)
        cs.enforce_constraint(self.lc - other.lc, m.lc, cond.lc())

    def is_eq_zero(self) -> Boolean:
        """1 iff self == 0, 2 constraints (bls-gadgets y_to_bit.rs:90-127)."""
        cs = self.cs
        if self.is_constant():
            return Boolean.const(cs, self.constant == 0)
        bit_v = None if self.value is None else (self.value == 0)
        bit = Boolean.new_witness(cs, bool(bit_v))
        inv_v = None
        if self.value is not None:
            inv_v = pow(self.value, -1, cs.p) if self.value != 0 else 0
        inv = FpVar.new_witness(cs, 0 if inv_v is None else inv_v)
        one = LinearCombination.constant(1)
        cs.enforce_constraint(self.lc, inv.lc, one - bit.lc())
        cs.enforce_constraint(self.lc, bit.lc(), LinearCombination())
        return bit

    # --- bits --------------------------------------------------------------
    def to_non_unique_bits_le(self):
        """MODULUS_BITS booleanity constraints + 1 packing constraint."""
        cs = self.cs
        nbits = cs.p.bit_length()
        bits = []
        if cs.is_in_setup_mode():
            for _ in range(nbits):
                bits.append(Boolean.new_witness(cs, None))
        else:
            v = self.value
            for i in range(nbits):
                bits.append(Boolean.new_witness(cs, (v >> i) & 1))
        pack = LinearCombination()
        for i, b in enumerate(bits):
            pack.add_scaled_(b.lc(), 1 << i)
        cs.enforce_constraint(pack, LinearCombination.constant(1), self.lc)
        return bits

    def to_bits_le(self):
        bits = self.to_non_unique_bits_le()
        enforce_smaller_or_equal_than_le(bits, self.cs.p - 1)
        return bits

    def normalize(self) -> Boolean:
        """bit = (self > (p-1)/2), via subtract-half + range-check
        (bls-gadgets y_to_bit.rs:129-162)."""
        cs = self.cs
        half = (cs.p - 1) // 2
        if self.is_constant():
            return Boolean.const(cs, self.constant > half)
        bit_v = None if self.value is None else (self.value > half)
        bit = Boolean.new_witness(cs, bool(bit_v))
        adj_v = None
        if self.value is not None:
            adj_v = self.value - half if self.value > half else self.value
        adjusted = FpVar.new_witness(cs, 0 if adj_v is None else adj_v)
        # 1 * (self - bit*half) = adjusted
        cs.enforce_constraint(
            LinearCombination.constant(1),
            self.lc - bit.lc().scale(half),
            adjusted.lc,
        )
        adjusted.enforce_smaller_or_equal_than_mod_minus_one_div_two()
        return bit

    def enforce_smaller_or_equal_than_mod_minus_one_div_two(self):
        bits = self.to_non_unique_bits_le()
        enforce_smaller_or_equal_than_le(bits, (self.cs.p - 1) // 2)
        return bits

    def enforce_cmp_leq(self, other: "FpVar"):
        """self <= other, both assumed < (p-1)/2 range semantics of ark's
        enforce_cmp(Less, allow_eq=true) for our bitmap use."""
        # ark: enforce smaller than via parity of 2*(other - self + 1)...
        # We use: d = other - self; enforce d in [0, (p-1)/2] by range check.
        d = other.sub(self)
        d.enforce_smaller_or_equal_than_mod_minus_one_div_two()


def enforce_smaller_or_equal_than_le(bits, constant: int):
    """Enforce that the little-endian bits are <= the given constant —
    ark Boolean::enforce_smaller_or_equal_than_le replicated operation for
    operation (kary-and over runs of ones; a MATERIALIZED and-gate plus an
    enforce-zero per zero position, ark's enforce_kary_nand), so constraint
    counts match the reference's pinned figures (y_to_bit.rs:211,251)."""
    if not bits:
        return
    cs = bits[0].cs
    cbits = [(constant >> i) & 1 for i in range(len(bits))]
    # walk MSB -> LSB
    current_run = []
    last_run = Boolean.true(cs)
    for i in reversed(range(len(bits))):
        a = bits[i]
        if cbits[i]:
            current_run.append(a)
        else:
            if current_run:
                current_run.append(last_run)
                last_run = Boolean.kary_and(current_run)
                current_run = []
            # ark enforce_kary_nand([last_run, a]): and-gate, then == 0
            nand = Boolean.kary_and([last_run, a])
            if nand.is_constant():
                assert not nand.constant, "bits exceed constant"
            else:
                cs.enforce_constraint(
                    nand.lc(), LinearCombination.constant(1),
                    LinearCombination(),
                )
