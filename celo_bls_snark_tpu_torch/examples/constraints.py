"""Constraint-count reporter for the full ValidatorSetUpdate circuit.

Parity: crates/epoch-snark/examples/constraints.rs:15-35 — synthesize the
empty circuit in setup mode for (num_validators, num_epochs), faults =
(n-1)/3, and print the R1CS size; plus the namespace-attribution breakdown
(the ConstraintLayer equivalent, relations/r1cs.py).

Usage: python -m celo_bls_snark_tpu_torch.examples.constraints [validators] [epochs]
"""

import sys

from ..hostmath.params import P
from ..relations.r1cs import ConstraintSystem
from ..snark.epochs import ValidatorSetUpdate


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    num_validators = int(argv[0]) if len(argv) > 0 else 4
    num_epochs = int(argv[1]) if len(argv) > 1 else 2
    faults = (num_validators - 1) // 3

    cs = ConstraintSystem(P, "setup")
    ValidatorSetUpdate.empty(num_validators, num_epochs).generate_constraints(cs)

    print(
        f"Number of constraints for {num_epochs} epochs ({num_validators} "
        f"validators, {faults} faults, hashes in BW6_761): {cs.num_constraints}"
    )
    print(f"instance variables: {cs.num_instance}")
    print(f"witness variables: {cs.num_witness}")
    print("\nby namespace:")
    for ns, count in sorted(
        cs.constraint_counts_by_namespace().items(), key=lambda kv: -kv[1]
    )[:20]:
        print(f"  {count:8d}  {ns or '(root)'}")


if __name__ == "__main__":
    main()
