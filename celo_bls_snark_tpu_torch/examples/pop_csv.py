"""PoP test-vector CSV dump.

Parity with crates/bls-crypto/examples/pop_csv.rs: N random keys, PoP over
a fixed address, CSV of (sk, pk, pop) hex triples.

Usage: python -m celo_bls_snark_tpu_torch.examples.pop_csv -n NUM -o OUT.csv
"""

import argparse
import secrets

from ..bls import PrivateKey
from ..hash_to_curve import direct_hash_to_g1
from ..utils.rngs import ChaChaRng

ADDRESS = bytes.fromhex("60515f8c59451e04ab4b22b3fc9a196b2ad354e6")


def main(argv=None):
    parser = argparse.ArgumentParser(
        "BLS Proof of Possession test vectors",
        description="Generates many proofs of possession for random keys",
    )
    parser.add_argument("-n", "--num", type=int, required=True)
    parser.add_argument("-o", "--out", required=True)
    args = parser.parse_args(argv)

    try_and_increment = direct_hash_to_g1()
    rng = ChaChaRng(secrets.token_bytes(32))
    with open(args.out, "w") as f:
        for _ in range(args.num):
            sk = PrivateKey.generate(rng)
            pk = sk.to_public()
            pop = sk.sign_pop(ADDRESS, try_and_increment)
            f.write(
                ",".join(
                    [sk.to_bytes().hex(), pk.to_bytes().hex(), pop.to_bytes().hex()]
                )
                + "\n"
            )


if __name__ == "__main__":
    main()
