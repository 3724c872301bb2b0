"""The verdicts the cells are judged against, on the copied host math.

Each check is the reference's pairing equation (crates/bls-crypto/src/bls/
{signature,batch,public}.rs) with one final exponentiation:

- grouped: e(sum sigma, -g2) prod_g e(sum_{i in g} H_i, apk_g) == 1, the
  block-sync batch_verify (signature.rs:101-155) with the hashes of one
  committee summed (exact by bilinearity), each sum taken over the lanes'
  points as signed multiples of the seals and hashes they derive from;
- strict: per block, e(sum r_i sigma_i, -g2) e(H_b, sum r_i pk_i) == 1 with
  the batch's own exponents r_i (Batch::verify, batch.rs:44-84);
- screen: the same with every r_i = 1, the aggregate screening that is not
  safe against rogue keys (signatures of one block shifted by +D and -D
  pass it);
- individual: every (sigma_i, pk_i) of a block passes
  e(sigma_i, -g2) e(H_b, pk_i) == 1 (Batch::verify_each, batch.rs:87-96).
  It is decided as one random linear combination of the block's checks
  with 128-bit exponents of the reference's own (not the batch's): a block
  with a failing entry passes it with probability 2^-128.

The block checks also have a discrete-logarithm form, for the cells whose
keys the benchmark made itself: with pk_i = sk_i g2 (the input maker's
construction) e(A, -g2) e(H, sum r_i pk_i) == 1 holds exactly when
A == (sum r_i sk_i) H in G1, which costs one multi-scalar multiplication in
G1 where the pairing form costs one in G2 and two Miller loops. Each run
checks the two forms against each other on a sample of blocks.
"""

import random

from . import pairing
from .group import G1, G2, endo, msm, weighted_sum
from .params import G2_GENERATOR, R

NEG_G2 = G2.neg(G2_GENERATOR)


def _terms_sum(terms):
    """sum over (points, counts, e) of endo(weighted sum, e): the map
    commutes with sums, so each class is summed first."""
    acc = None
    for points, counts, e in terms:
        acc = G1.add(acc, endo(weighted_sum(G1, points, counts), e))
    return acc


def grouped_ok(sig_terms, groups) -> bool:
    """sig_terms: [(seal points, their signed lane counts, e)], the lanes'
    seals being endo(count * point, e); groups: [(hash terms alike, apk)] a
    committee."""
    pairs = [(_terms_sum(sig_terms), NEG_G2)]
    for terms, apk in groups:
        pairs.append((_terms_sum(terms), apk))
    return pairing.pairing_check(pairs)


def strict_block_ok(h, sigs, pks, exps) -> bool:
    return pairing.pairing_check([(msm(G1, exps, sigs), NEG_G2),
                                  (h, msm(G2, exps, pks))])


def screen_block_ok(h, sigs, pks) -> bool:
    return strict_block_ok(h, sigs, pks, [1] * len(sigs))


def individual_block_ok(h, sigs, pks, seed) -> bool:
    rng = random.Random(seed)
    return strict_block_ok(h, sigs, pks, [rng.getrandbits(128) | 1 for _ in sigs])


def strict_block_dl(h, sigs, sks, exps) -> bool:
    k = sum(r * s for r, s in zip(exps, sks)) % R
    return msm(G1, exps, sigs) == G1.mul(k, h)


def screen_block_dl(h, sigs, sks) -> bool:
    return strict_block_dl(h, sigs, sks, [1] * len(sigs))


def individual_block_dl(h, sigs, sks) -> bool:
    table = G1.fixed_base_table(h, 4, R.bit_length())
    return all(s == G1.fixed_base_mul(table, k) for s, k in zip(sigs, sks))
