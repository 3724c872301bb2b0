"""The BW6-761 pairing engine of the epoch proof (the part of the JAX
package's snark/api.py that the prover's device path needs; setup, prove
and verify over the epoch circuit are not ported yet)."""

from ..hostmath import bw6
from ..hostmath.params import P as BW_FR
from . import groth16 as g16
from .groth16 import Engine

BW6_761_ENGINE = Engine(
    "bw6_761",
    BW_FR,
    bw6.G1,
    bw6.G2,
    bw6.G1_GENERATOR,
    bw6.G2_GENERATOR,
    bw6.pairing_check,
    46,
    g16._find_fr_generator(BW_FR, 46),
)
