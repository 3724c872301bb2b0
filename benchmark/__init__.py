"""The benchmark of celo_bls_snark_tpu_torch, the PyTorch/CUDA port: see
run.py. Nothing here imports JAX or the JAX package."""
