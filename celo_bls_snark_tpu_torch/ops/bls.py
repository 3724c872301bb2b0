"""BLS verification pipelines on the card (the PyTorch counterpart of the
main-path functions of the JAX package's ops/bls.py; reference:
crates/bls-crypto/src/bls/{public,signature,batch}.rs).

Most of these functions consume message HASH POINTS, as the reference's
`batch_verify_hashes` does; batch_verify_messages_device hashes the
messages on the card first (ops/hash_to_g1.py), as `batch_verify` does.
batch_verify_grouped_aot runs the grouped check as one CUDA graph per shape
(utils/aotcache.py), as the JAX package runs it as one executable.
"""

import numpy as np
import torch

from ..hostmath import curves as hostcurves
from ..hostmath.params import G2_GENERATOR
from ..utils import aotcache
from ..utils.profiling import device_span, device_sync, stage
from ..utils.tree import tree_map
from .field import FQ
from . import curve as dc
from . import hash_to_g1 as h2g
from . import pairing as dp
from . import tower as tw


def cat_lanes(a, b):
    """Two trees of [n, B] tensors -> one tree, lanes of `a` then `b`."""
    return tree_map(lambda x, y: torch.cat([x, y], dim=-1), a, b)


def pack_g1_affine(points, device):
    """Host affine G1 points (None = infinity -> (0,0)) -> (x, y) tensors."""
    xs = [0 if p is None else p[0] for p in points]
    ys = [0 if p is None else p[1] for p in points]
    return (FQ.pack(xs, device), FQ.pack(ys, device))


def pack_g2_affine(points, device):
    xs0 = [0 if p is None else p[0][0] for p in points]
    xs1 = [0 if p is None else p[0][1] for p in points]
    ys0 = [0 if p is None else p[1][0] for p in points]
    ys1 = [0 if p is None else p[1][1] for p in points]
    return (
        (FQ.pack(xs0, device), FQ.pack(xs1, device)),
        (FQ.pack(ys0, device), FQ.pack(ys1, device)),
    )


_NEG_G2 = {}


def neg_g2_gen_affine(device, batch=1):
    """-g2 as an affine batch (for the e(sigma, -g2) leg): packed once per
    device, broadcast (a view) to the batch."""
    device = torch.device(device)
    neg = _NEG_G2.get(device)
    if neg is None:
        neg = _NEG_G2[device] = pack_g2_affine([hostcurves.G2.neg(G2_GENERATOR)], device)
    return tree_map(lambda t: t.expand(t.shape[0], batch), neg)


def batch_verify_hashes_device(sig_aff, pubkeys_aff, hashes_aff):
    """e(sigma, -g2) * prod_i e(H_i, pk_i) == 1 (BDN18, n+1 pairings, one
    final exponentiation) — signature.rs:125-155, fully batched.

    sig_aff: (x, y) with batch 1; pubkeys_aff: G2 affine batch [B];
    hashes_aff: G1 affine batch [B]. Returns a bool tensor of shape [1]."""
    negg2 = neg_g2_gen_affine(sig_aff[0].device)
    return dp.pairing_check_product(
        cat_lanes(sig_aff, hashes_aff), cat_lanes(negg2, pubkeys_aff)
    )


def _call(name, fn):
    return fn()


def batch_verify_grouped_stages(sigs_jac, hashes_jac, apks_aff, groups: int,
                                stage=_call):
    """batch_verify_grouped_device with its intermediates: returns a dict
    with the affine P legs `p_aff`, the Miller-loop output `miller`, the
    tree product `product`, the final-exponentiation output `final_exp`
    and the verdict `ok` (bool tensor [1]).

    Each stage runs as `stage(name, fn)`, which must return `fn()`; a
    caller passes its own to time or count the stages (fold, to_affine,
    miller, product, final_exp, is_one) of exactly this pipeline. The fold
    and to_affine are the device span gpu.verify.legs."""

    def fold():
        # [sig groups | hash groups] -> 2G partial sums in one fused fold
        partials = dc.g1.msum_groups(
            cat_lanes(sigs_jac, hashes_jac), 2 * groups, fold_lanes=1024
        )
        sig_parts = tree_map(lambda x: x[..., :groups], partials)
        hsums = tree_map(lambda x: x[..., groups:], partials)
        asig = dc.g1.msum(sig_parts) if groups > 1 else sig_parts
        return cat_lanes(asig, hsums)

    with device_span("gpu.verify.legs", sigs_jac):
        folded = stage("fold", fold)
        p_aff = stage("to_affine", lambda: dc.g1.to_affine(folded))
    q_aff = cat_lanes(neg_g2_gen_affine(p_aff[0].device), apks_aff)
    miller = stage("miller", lambda: dp.miller_loop_batch(p_aff, q_aff))
    product = stage("product", lambda: dp.f12_product(miller))
    final_exp = stage("final_exp", lambda: dp.final_exponentiation(product))
    return {
        "p_aff": p_aff,
        "miller": miller,
        "product": product,
        "final_exp": final_exp,
        "ok": stage("is_one", lambda: tw.f12_is_one(final_exp)),
    }


def batch_verify_grouped_device(sigs_jac, hashes_jac, apks_aff, groups: int):
    """Block-sync batch verification with per-group hash aggregation — the
    batched form of `batch_verify_signature` (bls-snark-sys
    signatures.rs:280-333 -> signature.rs:101-155).

    Lanes are grouped by distinct (aggregated) public key: G contiguous
    blocks of B = lanes/G messages, message i of group g signed by apk_g.
    Within a group the pairing legs share Q = apk_g, so
      prod_i e(H_i, apk_g) == e(sum_i H_i, apk_g)
    and the reference's (n+1)-pairing equation collapses EXACTLY to G+1
    pairings: e(sum_all sigs, -g2) * prod_g e(Hsum_g, apk_g) == 1.

    sigs_jac / hashes_jac: G1 projective batches [G*B]; apks_aff: G2 affine
    batch [G]. Returns a bool tensor of shape [1]."""
    return batch_verify_grouped_stages(sigs_jac, hashes_jac, apks_aff, groups)["ok"]


def batch_verify_grouped_aot(sigs_jac, hashes_jac, apks_aff, groups: int):
    """batch_verify_grouped_device as one CUDA graph per shape
    (utils/aotcache.py): one replay in place of about 99,000 launches issued
    from Python at the benchmark's 524,288 messages. The benchmark, the
    hashing-included path and its bench call this; CPU tensors run the
    function itself."""
    fn = aotcache.jit(f"bls_grouped_{groups}",
                      lambda s, h, pk: batch_verify_grouped_device(s, h, pk, groups))
    return fn(sigs_jac, hashes_jac, apks_aff)


def batch_verify_messages_device(sigs_jac, apks_aff, domain, messages,
                                 extra_data=b"", groups: int = 1,
                                 composite: bool = False,
                                 num_counters: int = 24,
                                 compat: bool = True, cip22: bool = True):
    """The reference's `Signature::batch_verify` including message hashing
    (signature.rs:101-117) as one pipeline on the signatures' device:
    batched try-and-increment hash-to-G1 (ops/hash_to_g1.py; CIP22, the
    Pedersen CRH when `composite`; with cip22=False the variant before
    CIP22 over the direct hasher, as syncing nodes hash committed seals)
    feeding the grouped (G+1)-pairing check. The rare no-valid-counter
    lanes (probability ~0.58^num_counters) are hashed by the host hasher
    and merged on the card (hash_to_g1.py::hash_messages_device).

    sigs_jac: G1 projective [len(messages)]; apks_aff: G2 affine [groups];
    messages: equal-length byte strings, group g owning the contiguous
    lanes [g*B, (g+1)*B). extra_data: shared bytes or a per-message list.
    Returns a bool tensor of shape [1]. Its stages are timed under
    utils/profiling.py's names h2g.message_crh (CIP22), h2g.pack,
    h2g.round1, h2g.round2 and bls.pairing."""
    hashes_jac, _fallback = h2g.hash_messages_device(
        domain, messages, extra_data, composite, num_counters, compat,
        sigs_jac[0].device, cip22,
    )
    with stage("bls.pairing"):
        ok = batch_verify_grouped_aot(sigs_jac, hashes_jac, apks_aff, groups)
        device_sync(ok)
    return ok


def _interleave(a, b):
    """Lane-interleave two equal-batch trees: [B], [B] -> [2B]
    (a0 b0 a1 b1 ...)."""
    return tree_map(
        lambda x, y: torch.stack([x, y], dim=-1).reshape(*x.shape[:-1], -1), a, b
    )


def strict_batch_verify_device(expdigits, sigs_jac, pks_jac, hashes_aff,
                               groups: int, c: int = 4):
    """Many strict (rogue-key-defended) batch verifications in one program,
    the batched form of running `Batch::verify` per epoch (batch.rs:44-84
    via bls-snark-sys batch_verify_strict, signatures.rs:336-404).

    Per group g (one message/epoch, V entries):
      e(sum_i r_i sig_i, -g2) * e(H_g, sum_i r_i pk_i) == 1
    with per-entry random exponents r_i. The two random linear
    combinations run as Straus grouped MSMs (ops/msm.py: shared Horner
    doubling at group width); the 2G pairing legs share one batched Miller
    pass and one final exponentiation.

    expdigits: [nw, G*V] window digits of the random exponents
               (msm.window_digits, MSB-first, base 2^c);
    sigs_jac / pks_jac: projective G1/G2 batches [G*V];
    hashes_aff: G1 affine batch [G] (the per-epoch message hashes).
    Returns bool [G]: per-epoch results, as the reference's per-batch
    result array. The MSMs and the legs' affine forms are the device span
    gpu.verify.legs."""
    from . import msm as dmsm

    with device_span("gpu.verify.legs", sigs_jac):
        bsig = dmsm.straus_msm_groups(dc.g1, expdigits, sigs_jac, groups, c)
        bpk = dmsm.straus_msm_groups(dc.g2, expdigits, pks_jac, groups, c)
        negg2 = neg_g2_gen_affine(hashes_aff[0].device, groups)
        p = _interleave(dc.g1.to_affine(bsig), hashes_aff)
        q = _interleave(negg2, dc.g2.to_affine(bpk))
    return verify_pairs_device(p, q)


def verify_pairs_device(p_aff, q_aff):
    """Independent 2-pairing checks, fully batched: lanes 2i and 2i+1 form
    check i, e(P_{2i}, Q_{2i}) * e(P_{2i+1}, Q_{2i+1}) == 1. One batched
    Miller pass + ONE batched final exponentiation for all checks (the
    batched form of PublicKey::verify, public.rs:90-117). Returns bool
    [B/2]."""
    f = dp.miller_loop_batch(p_aff, q_aff)
    even = tree_map(lambda x: x[..., 0::2], f)
    odd = tree_map(lambda x: x[..., 1::2], f)
    e = dp.final_exponentiation(tw.f12_mul(even, odd))
    return tw.f12_is_one(e)


def aggregate_g2_device(pubkeys_jac):
    """Sum of a projective G2 batch -> batch-1 point (PublicKey::aggregate)."""
    return dc.g2.msum(pubkeys_jac)


def aggregate_g1_device(sigs_jac):
    """Sum of a projective G1 batch -> batch-1 point (Signature::aggregate)."""
    return dc.g1.msum(sigs_jac)


def scalars_to_bits(scalars, device, nbits=253):
    """Python ints -> [nbits, B] int32 MSB-first bit tensor on `device`."""
    a8 = np.frombuffer(
        b"".join(int(k).to_bytes((nbits + 7) // 8, "big") for k in scalars),
        dtype=np.uint8).reshape(len(scalars), -1)
    bits = np.unpackbits(a8, axis=1)[:, -nbits:]
    return torch.from_numpy(bits.T.astype(np.int32)).to(device)


def msm_g1_device(bits, points_jac):
    """Batched scalar-mul + tree-sum MSM (double-and-add form).

    bits: [nbits, B]; points_jac: G1 projective batch [B]. Returns batch-1
    projective point = sum_i scalar_i * P_i.
    The Pippenger bucketed version lives in ops/msm.py; this dense form is
    the small-batch path (PublicKey::batch / Signature::batch semantics,
    public.rs:47-65).
    """
    prods = dc.g1.scalar_mul_bits(bits, points_jac)
    return dc.g1.msum(prods)


def msm_g2_device(bits, points_jac):
    prods = dc.g2.scalar_mul_bits(bits, points_jac)
    return dc.g2.msum(prods)
