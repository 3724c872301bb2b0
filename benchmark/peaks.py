"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit) and the least time a field kernel's launch can take, a frozen
copy of chip_smoke.py's bound for the port's mont_mul."""

HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 67e12 / 2  # FP32 lane instructions a second, a ceiling on 32-bit multiplies


def mont_mul_bound_s(n: int, lanes: int) -> float:
    """One mont_mul<n> launch over `lanes` lanes: the larger of its bytes
    (two inputs read once, the output written once, 4 bytes a limb: 12 n
    bytes a lane) at the HBM rate and its 32-bit multiplies (A B and m p,
    each a low and a high half: 4 W^2 a lane, W = ceil(n / 2)) at the lane
    rate. The bytes decide at every n the program uses."""
    w = (n + 1) // 2
    return max(12 * n * lanes / HBM_BYTES_PER_S, 4 * w * w * lanes / LANE_OPS_PER_S)
