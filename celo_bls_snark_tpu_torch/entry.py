"""The flagship verification step at a small size (the counterpart of the
JAX package's __graft_entry__.py::entry): BDN18 aggregate-signature batch
verification, an (n+1)-pairing product check.

    fn, args = entry()          # on the card
    ok = fn(*args)              # bool tensor [1]
"""

from .hash_to_curve import composite_hash_to_g1_cip22
from .hostmath import curves as hc
from .hostmath.params import R
from .keys import SIG_DOMAIN, PrivateKey, PublicKey
from .ops import bls as dbls
from .ops import curve as dc
from .ops import pairing as dp
from .ops import tower as tw
from .utils.devices import require_device
from .utils.rngs import XorShiftRng


def example_inputs(n_messages=8, n_validators=4, device="cuda"):
    """A committee of `n_validators` signing `n_messages` CIP22-hashed
    messages: (sig_jac, hashes_aff, apk_aff) on `device`."""
    device = require_device(device)
    rng = XorShiftRng(b"graft-entry-seed")
    h2c = composite_hash_to_g1_cip22()
    sks = [PrivateKey.generate(rng) for _ in range(n_validators)]
    apk = PublicKey.aggregate([sk.to_public() for sk in sks])
    sk_sum = sum(sk.sk for sk in sks) % R
    hashes, sigs = [], []
    for i in range(n_messages):
        h = h2c.hash(SIG_DOMAIN, b"entry block %d" % i, b"")
        hashes.append(h)
        sigs.append(hc.G1.mul(sk_sum, h))
    sig_jac = dc.g1_pack(sigs, device)
    hashes_aff = dbls.pack_g1_affine(hashes, device)
    apk_aff = dbls.pack_g2_affine([apk.pt] * n_messages, device)
    return sig_jac, hashes_aff, apk_aff


def verify_stages(sig_jac, hashes_aff, apk_aff):
    """The verification with its intermediates: a dict with `final_exp`
    (the Fq12 final-exponentiation output) and `ok` (bool tensor [1])."""
    asig_aff = dc.g1.to_affine(dc.g1.msum(sig_jac))
    negg2 = dbls.neg_g2_gen_affine(asig_aff[0].device)
    f = dp.miller_loop_batch(dbls.cat_lanes(asig_aff, hashes_aff),
                             dbls.cat_lanes(negg2, apk_aff))
    e = dp.final_exponentiation(dp.f12_product(f))
    return {"final_exp": e, "ok": tw.f12_is_one(e)}


def verify(sig_jac, hashes_aff, apk_aff):
    return verify_stages(sig_jac, hashes_aff, apk_aff)["ok"]


def entry(device="cuda"):
    """Returns (fn, example_args): the flagship verification step."""
    return verify, example_inputs(device=device)


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", bool(fn(*args)[0]))
