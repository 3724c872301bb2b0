"""Simple aggregated signature demo.

Parity with crates/bls-crypto/examples/simple_signature.rs: generate three
keys, sign a message, aggregate (with one key double-counted on both sides),
verify the aggregate.

Usage: python -m celo_bls_snark_tpu_torch.examples.simple_signature -m MESSAGE
"""

import argparse
import secrets

from ..bls import PrivateKey, PublicKey, Signature
from ..hash_to_curve import composite_hash_to_g1
from ..utils.rngs import ChaChaRng


def main(argv=None):
    parser = argparse.ArgumentParser(
        "SimpleAggregatedSignature",
        description="Show an example of a simple signature with a random key",
    )
    parser.add_argument("-m", "--message", required=True, help="the message to sign")
    args = parser.parse_args(argv)
    message = args.message.encode()

    rng = ChaChaRng(secrets.token_bytes(32))
    try_and_increment = composite_hash_to_g1()

    sk1 = PrivateKey.generate(rng)
    print("sk1:", sk1.to_bytes().hex())
    sk2 = PrivateKey.generate(rng)
    print("sk2:", sk2.to_bytes().hex())
    sk3 = PrivateKey.generate(rng)
    print("sk3:", sk3.to_bytes().hex())

    sig1 = sk1.sign(message, b"", try_and_increment)
    print("sig1:", sig1.to_bytes().hex())
    sig2 = sk2.sign(message, b"", try_and_increment)
    print("sig2:", sig2.to_bytes().hex())
    sig3 = sk3.sign(message, b"", try_and_increment)
    print("sig3:", sig3.to_bytes().hex())

    apk = PublicKey.aggregate(
        [sk1.to_public(), sk2.to_public(), sk3.to_public(), sk3.to_public()]
    )
    print("apk:", apk.to_bytes().hex())
    asig1 = Signature.aggregate([sig1, sig3])
    asig2 = Signature.aggregate([sig2, sig3])
    asig = Signature.aggregate([asig1, asig2])
    print("asig:", asig.to_bytes().hex())
    apk.verify(message, b"", asig, try_and_increment)
    print("aggregated signature verified successfully")


if __name__ == "__main__":
    main()
