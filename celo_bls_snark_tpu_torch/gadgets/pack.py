"""Public-input multipacking gadget.

Parity with crates/epoch-snark/src/gadgets/pack.rs (MultipackGadget):
chunk BE bits into field elements of `element_size` bits, allocate each as
instance (or witness), and enforce the packing LC equals the element.
"""

from ..relations.r1cs import LinearCombination
from .vars import Boolean, FpVar


def multipack(cs, bits, element_size: int, as_input: bool):
    """bits: list[Boolean] (BE within each chunk). Returns list[FpVar]."""
    out = []
    with cs.ns("multipack"):
        for start in range(0, len(bits), element_size):
            chunk = bits[start : start + element_size]
            if cs.is_in_setup_mode():
                val = None
            else:
                val = 0
                for b in chunk:
                    val = (val << 1) | int(bool(b.value))
            alloc = FpVar.new_input if as_input else FpVar.new_witness
            fp = alloc(cs, 0 if val is None else val)
            pack_lc = LinearCombination()
            for i, b in enumerate(chunk):
                pack_lc.add_scaled_(b.lc(), 1 << (len(chunk) - 1 - i))
            cs.enforce_constraint(
                pack_lc, LinearCombination.constant(1), fp.lc
            )
            out.append(fp)
    return out


def pack_native(bits, p: int, element_size: int):
    """Native pack (gadgets/mod.rs:75-83) for cross-checking."""
    out = []
    for start in range(0, len(bits), element_size):
        chunk = bits[start : start + element_size]
        v = 0
        for b in chunk:
            v = (v << 1) | int(bool(b))
        out.append(v % p)
    return out
