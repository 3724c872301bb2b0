"""celo_bls_snark_tpu_torch — BLS12-377 aggregate-signature batch
verification in PyTorch, with hand-written CUDA kernels for an NVIDIA
Hopper card (H100).

The module names follow the JAX package of this repository, so that each
module here has a counterpart of the same name there:

  hostmath/       pure-Python bigint oracle (fields, curves) and constants
  utils/          RNG replicas, Blake2s
  hashers/        Blake2s/Blake2Xs + Bowe-Hopwood Pedersen CRH
  hash_to_curve/  CIP22 try-and-increment (host input builder)
  keys.py         private/public keys for the input builder
  ops/            batched device arithmetic: Montgomery fields (with the
                  CUDA kernels in csrc/), towers, curves, pairing, BLS,
                  MSM, NTT, and the message hashing of verification
                  (Blake2s/Blake2Xs, Edwards-BW6 Pedersen CRH, CIP22
                  hash-to-G1)
  batch.py        exponent sizing of the strict batch verifier
  entry.py        the small flagship verification step
  bench.py        aggregate-verification throughput on the card
  convert.py      numpy pytrees <-> torch tensor trees

Field batches are [n_limbs, B] int32 tensors of 16-bit limbs with one
guard limb (R = 2^(16 n)); values stay lazy between multiplies within
LAZY_P_BUDGET * p, and every multiply returns canonical limbs of value
< 2p.
"""

__version__ = "0.1.0"
