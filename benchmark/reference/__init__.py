"""The benchmark's plain reference: BLS12-377 on Python integers.

A frozen copy of the host math (params, fp, fp2, fq12, curves, pairing) and
of the host hashers (blake2s, rngs, direct, composite, h2c_common, cip22,
try_and_increment), the verdicts that the benchmark's cells are judged against
(verify.py), the input maker (inputs.py), the packer into the card's limb
layout (pack.py) and the worker pool and on-disk cache that keep the set-up
short (work.py).

Nothing here imports torch, the program under test or JAX: the reference
stays the same whatever a later change does to the program.
"""
