"""BLS12-377 / BW6-761 / Edwards curve parameters.

All constants are derived from the BLS12-377 curve parameter ``X`` where
possible, with hard asserts against the published hex values, so a typo cannot
survive module import.

Parity notes (files of the Rust reference, celo-org/celo-bls-snark-rs):
  - Curves consumed by the reference via arkworks git deps
    (crates/bls-crypto/Cargo.toml:8-14). Signatures live in BLS12-377 G1,
    public keys in G2, secret keys in Fr (README.md:36-46).
  - The SNARK outer curve is BW6-761 whose scalar field equals BLS12-377's
    base field (crates/epoch-snark/src/api/mod.rs:11-16).
  - The Pedersen CRH runs over the twisted Edwards curve on BW6-761's scalar
    field, i.e. over BLS12-377's Fq (crates/bls-crypto/src/hashers/composite.rs:8).
"""

# --------------------------------------------------------------------------
# BLS12-377
# --------------------------------------------------------------------------

# BLS family parameter (positive, low hamming weight).
X = 0x8508C00000000001

# Scalar field (Fr) modulus: r = X^4 - X^2 + 1  (253 bits)
R = X**4 - X**2 + 1
assert R == 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001

# Base field (Fq) modulus: p = ((X-1)^2 / 3) * r + X  (377 bits)
P = ((X - 1) ** 2 * R) // 3 + X
assert (
    P
    == 0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001
)

# Curve: y^2 = x^3 + 1 over Fq  (a = 0, b = 1)
G1_A = 0
G1_B = 1

# G1 cofactor h1 = (X-1)^2 / 3
G1_COFACTOR = (X - 1) ** 2 // 3
assert G1_COFACTOR == 0x170B5D44300000000000000000000000

# G2 cofactor (standard BLS12 formula)
G2_COFACTOR = (X**8 - 4 * X**7 + 5 * X**6 - 4 * X**4 + 6 * X**3 - 4 * X**2 - 4 * X + 13) // 9

# Fq2 = Fq[u] / (u^2 - QNR) with QNR = -5
FQ2_NONRESIDUE = P - 5

# G2 curve over Fq2: y^2 = x^3 + B2 with B2 = 1/u = -(1/5) * u  (D-type twist of b=1)
G2_B_C0 = 0
G2_B_C1 = (-pow(5, -1, P)) % P
assert (
    G2_B_C1
    == 0x010222F6DB0FD6F343BD03737460C589DC7B4F91CD5FD889129207B63C6BF8000DD39E5C1CCCCCCD1C9ED9999999999A
)

# Fq6 = Fq2[v] / (v^3 - u); Fq12 = Fq6[w] / (w^2 - v).

# Prime-subgroup generators (arkworks ark-bls12-377 conventions; checked
# on-curve and of order R in tests/test_hostmath_curves.py).
G1_GENERATOR = (
    81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695,
    241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030,
)
G2_GENERATOR = (
    (
        233578398248691099356572568220835526895379068987715365179118596935057653620464273615301663571204657964920925606294,
        140913150380207355837477652521042157274541796891053068589147167627541651775299824604154852141315666357241556069118,
    ),
    (
        63160294768292073209381361943935198908131692476676907196754037919244929611450776219210369229519898517858833747423,
        149157405641012693445398062341192467754805999074082136895788947234480009303640899064710353187729182149407503257491,
    ),
)

# Serialized byte sizes (arkworks CanonicalSerialize: LE bytes, flags in the
# top 2 bits of the final byte).
FQ_BYTES = 48       # 377 bits -> 48 bytes
FR_BYTES = 32       # 253 bits -> 32 bytes
G1_SER_BYTES = 48   # compressed
G2_SER_BYTES = 96   # compressed (x.c0 || x.c1)

# Montgomery constant used by arkworks' 6x64-limb representation of Fq. Only
# needed host-side to replicate `Fq::rand` (which interprets raw sampled limbs
# as the Montgomery representation).
FQ_MONT_R = (1 << 384) % P
FR_MONT_R = (1 << 256) % R

# --------------------------------------------------------------------------
# Twisted Edwards curve over Fq(BLS12-377) — "ed-on-bw6-761"/"ed-on-cp6-782"
#   a*x^2 + y^2 = 1 + d*x^2*y^2
# Hosts the Bowe-Hopwood Pedersen CRH
# (crates/bls-crypto/src/hashers/composite.rs:29-32).
# --------------------------------------------------------------------------
ED_A = P - 1        # a = -1
ED_D = 79743
ED_COFACTOR = 8

# --------------------------------------------------------------------------
# BW6-761 (outer curve for the epoch SNARK; scalar field == BLS12-377 Fq)
# --------------------------------------------------------------------------
# BW6-761 was constructed (EHG20) from BLS12-377: its base field modulus is a
# 761-bit prime; its scalar field is exactly P above.
BW6_R = P  # scalar field of BW6-761 == base field of BLS12-377

# 761-bit base field modulus of BW6-761 (EHG20, https://eprint.iacr.org/2020/351)
BW6_P = 0x0122E824FB83CE0AD187C94004FAFF3EB926186A81D14688528275EF8087BE41707BA638E584E91903CEBAFF25B423048689C8ED12F9FD9071DCD3DC73EBFF2E98A116C25667A8F8160CF8AEEAF0A437E6913E6870000082F49D00000000008B
assert BW6_P.bit_length() == 761

# BW6-761: y^2 = x^3 - 1 over Fp761 (a=0, b=-1); G2: y^2 = x^3 + 4
BW6_G1_B = BW6_P - 1
BW6_G2_B = 4
