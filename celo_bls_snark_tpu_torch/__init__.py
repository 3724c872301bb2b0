"""celo_bls_snark_tpu_torch — BLS12-377 aggregate-signature batch
verification and the Plumo epoch SNARK (Groth16 over BW6-761) in PyTorch,
with hand-written CUDA kernels for an NVIDIA Hopper card (H100).

The module names follow the JAX package of this repository, so that each
module here has a counterpart of the same name there:

  hostmath/       pure-Python bigint oracle (fields, curves) and constants
  utils/          RNG replicas, Blake2s, bit and point serialization,
                  config, profiling
  hashers/        Blake2s/Blake2Xs + Bowe-Hopwood Pedersen CRH
  hash_to_curve/  try-and-increment and CIP22 hash-to-G1 (host)
  bls/            keys, signatures, aggregation, the strict batch
                  verifier and the public-key cache (host)
  keys.py,        re-exports of bls/keys.py and bls/batch.py
  batch.py
  ops/            batched device arithmetic: Montgomery fields (with the
                  CUDA kernels in csrc/), towers, curves, pairing, BLS,
                  MSM, NTT, and the message hashing of verification
                  (Blake2s/Blake2Xs, Edwards-BW6 Pedersen CRH, CIP22
                  hash-to-G1)
  relations/      the R1CS constraint system
  gadgets/        R1CS gadgets: booleans, field and tower variables,
                  curves, the pairing, BLS verify, Blake2s, Pedersen,
                  hash-to-group, in-circuit Groth16 verify
  snark/          Groth16 (groth16.py), the device accelerator
                  (accel.py), the epoch circuit (epochs.py,
                  single_update.py, gadgets_epoch.py,
                  hash_to_bits_circuit.py, epoch_block.py, encoding.py,
                  fixtures.py), key and proof bytes (serialize_bw6.py,
                  serialize_pk.py), matrix digests (matrix_hash.py) and
                  the public API: trusted_setup, prove, verify (api.py)
  entry.py        the small flagship verification step
  bench.py        aggregate-verification throughput on the card
  convert.py      numpy pytrees <-> torch tensor trees
  scripts/        benches and profiles on the card, run_e2e.py

Field batches are [n_limbs, B] int32 tensors of 16-bit limbs with one
guard limb (R = 2^(16 n)); values stay lazy between multiplies within
LAZY_P_BUDGET * p, and every multiply returns canonical limbs of value
< 2p.
"""

__version__ = "0.1.0"
