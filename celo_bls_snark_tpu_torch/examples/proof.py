"""Timed epoch-SNARK end-to-end: trusted_setup -> prove -> verify of the
full ValidatorSetUpdate circuit.

Parity: crates/epoch-snark/examples/proof.rs:20-76 — same CLI shape
(num_validators, num_epochs, hashes_in_bls12_377), same faults formula
(n-1)/3, timed stages. The setup/prover MSM+FFT stages run on the card
(snark/accel.py) unless --device says otherwise: "cpu" runs every
kernel's plain version, "none" the host path (snark/api.py's device).

Usage: python -m celo_bls_snark_tpu_torch.examples.proof [validators] [epochs]
           [two_snark] [--device cuda|cpu|none]
Note: full-size runs take minutes on the card and hours on the CPU; see
scripts/run_e2e.py for the persisted-proving-key workflow.
"""

import sys
import time

from ..snark.api import trusted_setup, prove, verify_parsed
from ..snark.fixtures import generate_test_data
from ..utils.rngs import XorShiftRng


def main(argv=None, device="cuda"):
    argv = list(argv if argv is not None else sys.argv[1:])
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    device = None if device in (None, "none") else device
    num_validators = int(argv[0]) if len(argv) > 0 else 4
    num_epochs = int(argv[1]) if len(argv) > 1 else 2
    two_snark = bool(int(argv[2])) if len(argv) > 2 else False
    faults = (num_validators - 1) // 3

    rng = XorShiftRng(b"proof-example-rs")

    t0 = time.time()
    params = trusted_setup(
        num_validators, num_epochs, faults, rng,
        hashes_in_bls12_377=two_snark, device=device,
    )
    print(f"trusted setup: {time.time()-t0:.1f}s", flush=True)

    first_epoch, transitions, last_epoch = generate_test_data(
        num_validators, faults, num_epochs
    )

    t0 = time.time()
    proof = prove(
        params, num_validators, first_epoch, transitions,
        max_transitions=num_epochs, device=device,
    )
    print(f"prove: {time.time()-t0:.1f}s", flush=True)

    t0 = time.time()
    ok = verify_parsed(params.epochs.vk, first_epoch, last_epoch, proof)
    print(f"verify: {ok} [{time.time()-t0:.1f}s]", flush=True)
    assert ok
    print(
        f"EPOCH SNARK e2e OK ({num_validators} validators, {num_epochs} "
        f"epochs, {faults} faults, two_snark={two_snark})"
    )


if __name__ == "__main__":
    main()
