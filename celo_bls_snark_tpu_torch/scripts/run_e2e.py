"""End-to-end epoch SNARK on the card: trusted_setup -> prove -> verify of
the full ValidatorSetUpdate circuit (the reference's e2e.rs configuration:
4 validators, 1 fault, 2 transitions), with the setup's generator
multiples and the prover's MSMs and h-polynomial on the card
(snark/accel.py) and the proving key kept on disk between runs.

    python3 -m celo_bls_snark_tpu_torch.scripts.run_e2e [validators] [transitions]

Environment: E2E_FAULTS (default 1), E2E_TWO_SNARK=1 (the BLS12-377
helper proof), E2E_PROVE_TRANSITIONS (default all: fewer pads the rest
with dummy epochs), E2E_PROVE_REPEAT (default 2), E2E_PK_PATH (default
.e2e_pk_torch[.2snark].bin in the working directory). Prints seconds for
each stage and proof: setup, saving and loading the key, each proof,
verify and the tampered check.
"""

import os
import sys
import time


def dump_stages(header):
    from ..utils.profiling import report, reset

    print(f"--- {header} ---")
    for name, ent in sorted(report().items()):
        print(f"{name:32s} {ent['total_s']:9.3f}s  x{ent['calls']}")
    reset()


def main():
    import torch

    from ..snark.api import Parameters, prove, trusted_setup, verify_parsed
    from ..snark.fixtures import generate_test_data
    from ..snark.serialize_bw6 import vk_to_bytes
    from ..snark.serialize_pk import pk_from_bytes, pk_to_bytes
    from ..utils.rngs import XorShiftRng

    faults = int(os.environ.get("E2E_FAULTS", "1"))
    two_snark = bool(int(os.environ.get("E2E_TWO_SNARK", "0")))
    num_validators = int(sys.argv[1]) if len(sys.argv) > 1 else 3 * faults + 1
    num_transitions = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    prove_transitions = int(os.environ.get("E2E_PROVE_TRANSITIONS", num_transitions))
    repeats = int(os.environ.get("E2E_PROVE_REPEAT", "2"))
    suffix = ".2snark" if two_snark else ""
    pk_path = os.environ.get("E2E_PK_PATH", f".e2e_pk_torch{suffix}.bin")

    print(f"config: validators={num_validators} faults={faults} "
          f"transitions={num_transitions} prove_transitions={prove_transitions} "
          f"two_snark={two_snark} device={torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    params = trusted_setup(
        num_validators, num_transitions, faults,
        XorShiftRng(b"e2e-trusted-setp"), hashes_in_bls12_377=two_snark,
    )
    t1 = time.perf_counter()
    print(f"setup: {t1 - t0:.3f}s ({len(params.epochs.a_query)} vars, "
          f"{len(params.epochs.h_query) + 1} domain)", flush=True)
    dump_stages("stage breakdown setup")
    with open(pk_path, "wb") as f:
        f.write(pk_to_bytes(params.epochs, "bw6_761", compressed=False))
    if two_snark:
        with open(pk_path + ".helper", "wb") as f:
            f.write(pk_to_bytes(params.hash_to_bits, "bls12_377", compressed=False))
    t2 = time.perf_counter()
    print(f"setup: saved {os.path.getsize(pk_path)} bytes to {pk_path} in "
          f"{t2 - t1:.3f}s", flush=True)
    with open(pk_path, "rb") as f:
        pk = pk_from_bytes(f.read(), "bw6_761", compressed=False, validate=False)
    helper_pk = None
    if two_snark:
        with open(pk_path + ".helper", "rb") as f:
            helper_pk = pk_from_bytes(f.read(), "bls12_377", compressed=False,
                                      validate=False)
    t3 = time.perf_counter()
    print(f"setup: loaded {pk_path} in {t3 - t2:.3f}s", flush=True)
    if vk_to_bytes(pk.vk) != vk_to_bytes(params.epochs.vk):
        raise SystemExit("the loaded verifying key differs from the saved one")
    params = Parameters(epochs=pk, hash_to_bits=helper_pk)

    t4 = time.perf_counter()
    first_epoch, transitions, _ = generate_test_data(
        num_validators, faults, num_transitions
    )
    used = transitions[:prove_transitions]
    last_epoch = used[-1].block
    print(f"fixtures: {time.perf_counter() - t4:.3f}s", flush=True)

    for it in range(repeats):
        t5 = time.perf_counter()
        proof = prove(params, num_validators, first_epoch, used,
                      max_transitions=num_transitions)
        t6 = time.perf_counter()
        print(f"prove[{it}]: {t6 - t5:.3f}s peak_bytes="
              f"{torch.cuda.max_memory_allocated()}", flush=True)
        dump_stages(f"stage breakdown prove[{it}]")

    t7 = time.perf_counter()
    ok = verify_parsed(params.epochs.vk, first_epoch, last_epoch, proof)
    t8 = time.perf_counter()
    bad = verify_parsed(params.epochs.vk, first_epoch, first_epoch, proof)
    t9 = time.perf_counter()
    print(f"verify: {t8 - t7:.3f}s ok={ok}; tampered: {t9 - t8:.3f}s "
          f"rejected={not bad}", flush=True)
    if not ok or bad:
        raise SystemExit("E2E FAIL")
    print("E2E PASS")


if __name__ == "__main__":
    main()
