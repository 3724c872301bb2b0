"""UInt32 gadget: 32 LSB-first Booleans + modular arithmetic.

The ark-r1cs-std UInt32 equivalent consumed by the in-circuit Blake2s
(crates/bls-gadgets/src/hash_to_group.rs via ark-crypto-primitives).
Costs: xor = 1 constraint/bit, rotr = free, addmany = (32 + carry) bit
allocations + 1 packing constraint.
"""

from ..relations.r1cs import LinearCombination
from .vars import Boolean


class UInt32:
    def __init__(self, bits):
        assert len(bits) == 32
        self.bits = list(bits)  # LSB first
        self.cs = bits[0].cs

    @classmethod
    def constant(cls, cs, v: int):
        return cls([Boolean.const(cs, bool((v >> i) & 1)) for i in range(32)])

    @classmethod
    def new_witness(cls, cs, v):
        return cls(
            [
                Boolean.new_witness(cs, bool((v >> i) & 1) if v is not None else False)
                for i in range(32)
            ]
        )

    @classmethod
    def from_bits_le(cls, bits):
        return cls(bits)

    def value(self):
        v = 0
        for i, b in enumerate(self.bits):
            if b.value is None:
                return None
            v |= int(bool(b.value)) << i
        return v

    def xor(self, o: "UInt32"):
        return UInt32([a.xor(b) for a, b in zip(self.bits, o.bits)])

    def rotr(self, n: int):
        n %= 32
        return UInt32(self.bits[n:] + self.bits[:n])

    @staticmethod
    def addmany(cs, operands):
        """Sum mod 2^32 (ark UInt32::addmany): one field accumulation, a
        (32 + log2(k))-bit witnessed decomposition, low 32 bits out."""
        k = len(operands)
        assert k >= 2
        nbits = 32 + (k - 1).bit_length()
        total_lc = LinearCombination()
        total_val = 0
        known = True
        for op in operands:
            for i, b in enumerate(op.bits):
                total_lc.add_scaled_(b.lc(), 1 << i)
            v = op.value()
            if v is None:
                known = False
            else:
                total_val += v
        out_bits = []
        for i in range(nbits):
            out_bits.append(
                Boolean.new_witness(
                    cs, bool((total_val >> i) & 1) if known else False
                )
            )
        pack = LinearCombination()
        for i, b in enumerate(out_bits):
            pack.add_scaled_(b.lc(), 1 << i)
        cs.enforce_constraint(pack, LinearCombination.constant(1), total_lc)
        return UInt32(out_bits[:32])
