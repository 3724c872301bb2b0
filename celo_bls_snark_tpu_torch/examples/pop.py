"""Proof-of-possession generator.

Parity with crates/bls-crypto/examples/pop.rs: read a serialized private
key (hex), produce a PoP over the serialized public key, verify, print hex.

Usage: python -m celo_bls_snark_tpu_torch.examples.pop -k SK_HEX
"""

import argparse

from ..bls import PrivateKey
from ..hash_to_curve import direct_hash_to_g1


def main(argv=None):
    parser = argparse.ArgumentParser(
        "BLS Proof of Possession",
        description="Generates a proof of possession for the given private key",
    )
    parser.add_argument("-k", "--key", required=True, help="the BLS private key (hex)")
    args = parser.parse_args(argv)

    try_and_increment = direct_hash_to_g1()
    sk = PrivateKey.from_bytes(bytes.fromhex(args.key))
    pk = sk.to_public()
    pk_bytes = pk.to_bytes()
    pop = sk.sign_pop(pk_bytes, try_and_increment)
    pk.verify_pop(pk_bytes, pop, try_and_increment)
    print(pop.to_bytes().hex())


if __name__ == "__main__":
    main()
