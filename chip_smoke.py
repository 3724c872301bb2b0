"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Phases (each prints one line or more; any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, and the build of csrc/*.cu with nvcc for sm_90a (registers
     and spills per kernel from ptxas);
  2. kernels, exactly against their plain PyTorch versions on the card, on
     random lazy inputs in (-256p, 256p) with signed limbs (the first lanes
     hold 0, 1, p - 1, the budget's ends +-255p and values whose top limb
     is nonzero), at n = 17, 25, 49 and B in {1, 127, 128, 4099, 2^20}:
     mont_mul and mont_redc (32-bit words; also against the 16-bit-radix
     plain versions, and against the integer model at B = 127), mont_mul_tc
     (also exactly against mont_mul); at n = 25 mont_mul_shape at each
     block size (also exactly against mont_mul). Then, again exactly
     against the plain version, each kernel's time, bound and plain-version
     time at the widths the paths launch, and mont_mul_shape's five shapes
     at the sweep's width, printed at the end as one `kernels` line (`ms`
     is the card's time per launch, from a replayed CUDA graph of the
     launches; `eager_ms` the time per call issued from Python);
     Then the cyclotomic squaring's kernel (f12_cyclo_sq, csrc/
     cyclo_sq.cu) at 1, 300, 6,000 and 2^16 lanes, exactly against the
     composition it replaces on the card and on the CPU, timed beside it
     (one `cyclo_sq` line); and so the Fq12 multiply's kernel (f12_mul,
     csrc/f12_mul.cu), a product and a square, at 1, 33, 300, 600, 6,000
     and 12,000 lanes (one `f12_mul` line); their rows join the `kernels`
     line;
  3. entry(): the 8-message, 4-validator verification is True on the
     card, a tampered batch is False, and the card's final-exponentiation
     output equals the CPU run's limb for limb;
  4. the verification path at the benchmark's defaults (524,288 messages,
     100 validators, one group, the benchmark's seed), through the
     benchmark's CUDA graph (ops/bls.py::batch_verify_grouped_aot): with
     the launch counts set to 0 just before and read just after, the two
     warm-up verifications (an eager run; a capture and its replay) are
     True; a
     stage-by-stage eager run of the same pipeline gives each stage's time
     and launches, and its affine P legs equal the host's; the staged
     pipeline captured as a graph gives the same limbs at every stage
     (final_exp included); a tampered batch is False through the graph; 2
     timed replays (the benchmark itself takes 5) give the metric line,
     with 2 eager verifications beside them; one profiled replay gives the
     card's busy time;
  5. the launch-shape sweep of scripts/prof_field.py (mont_mul_shape);
  6. the Groth16 prover's device path at the epoch circuit's width,
     through snark/accel.py's DeviceAccel("bw6_761") by the stage functions
     of scripts/bench_msm_ntt.py: fixed-base batch of 2^20 scalars, MSM of
     2^20 BW6-761 points against one host scalar multiplication, the
     h-polynomial at d = 2^20 against host evaluations at random points and
     at d = 2^12 against the host fft pipeline, an ntt_fr round trip at
     2^20; per stage the seconds, launches and peak memory;
  7. the same MSM and h-polynomial under mul_kernel("tc"): the same point
     and the same limbs, every multiply through mont_mul_tc; then one
     profiled MSM (under mont_mul) for the card's busy share;
  8. mesh: parallel/ at world size 1 on a real NCCL group (init_distributed
     with a file:// store), on the prover phase's own 2^20 inputs and
     results: sharded_compute_h at d = 2^20 over BW6-Fr against
     compute_h_evals' limbs, the four-step NTT round trip at 2^20 over both
     scalar fields against the radix-2 NTT (timed beside it) and the host
     at sampled lanes, the sharded Pippenger MSM against the single card's
     point, the sharded signature sum and pairing check on the entry
     inputs and on 1,024 pairs (True, and False when tampered),
     entry.dryrun_multichip, and a size-1 set_mesh that leaves the
     accelerator's launches unchanged; seconds per function and launches
     by limb count. Each function's device work is one CUDA graph with its
     NCCL collectives: every function is called until its graphs replay
     (eager, capture, replay), each call's result equal to the first's;
     the graphs are checked and dropped before the group is destroyed;
  9. hash_verify: hashing-included batch verification at the JAX hash
     bench's configuration (16,384 messages, 100 validators, 24 counters,
     compat mode) through ops/bls.py::batch_verify_messages_device, for the
     DirectHasher and the composite CRH: signatures (sum sk) H built on the
     card from the path's own hashes; with the launch counts set to 0 just
     before and read just after, the warm-up verification is True; 256
     sampled lanes, every lane round 2 resolved and every host-fallback lane
     equal the host TryAndIncrementCIP22's points; a tampered batch is
     False; 2 timed verifications give the metric line (scripts/
     bench_hash_verify.py's, with seconds per stage); one profiled
     DirectHasher verification gives the card's busy share;
 10. strict_verify: strict per-epoch batch verification at
     scripts/bench_strategies.py's configuration (300 epochs x 20
     validators, per-epoch extra_data, composite hashing on the card, c = 4,
     17-byte exponents): every epoch True, one planted bad signature flips
     exactly its epoch; seconds of hashing plus verification;
 11. strategies: scripts/bench_strategies.py, the reference's four
     batch-BLS strategies, at its shape (300 blocks x 20 fresh validators a
     block, c = 4) through the script's own functions: derive's keys,
     signatures and aggregates equal the host's at sampled lanes and
     blocks and in total; per strategy, block hashing on the card
     included, a first call (eager) and a second (the capture) True, 2
     timed replays, its own tamper False, and a compensating forgery (two
     signatures of one block shifted by +D and -D, the aggregates
     recomputed) True for the two aggregate screenings and False for the
     batch and individual verifications; one line per strategy with
     seconds, launches, peak memory and the card;
 12. epoch_snark: the epoch SNARK at the reference's e2e configuration
     (crates/epoch-snark/tests/e2e.rs: 4 validators, 1 fault, 2
     transitions, one SNARK) through snark/api.py on the card: first one
     BW6-761 G2 fixed-base batch and G2 MSM against hostmath/bw6.py; then
     trusted_setup and prove with device="cuda" (the launch counts set to 0
     just before the setup and read just after the proof), the proof
     verifies, a tampered last epoch does not, and the byte API verifies
     the serialized key and proof; prewarm_prove(block=True) captures the
     prover's graphs for the key and a second proof with the same key
     replays them and equals the first; seconds per stage, the constraint count,
     the domain, peak memory and launches per kernel and limb count. Then
     the 2-SNARK helper on the BLS12-377 engine: setup of HashToBits(2)
     and generate_hash_helper on the card, its proof verified against the
     public inputs the helper statement fixes;
 13. the `kernels` line and the last line: {"ok": true, "device": {...}}.

Every program that runs as a CUDA graph (utils/aotcache.py) is checked in
the phase that called it, at its largest shape there: on the arguments of
that call it is captured (if the path did not capture it already), its
replay equals its function run eagerly, limb for limb, and both are timed
between CUDA events; one `graph` line a program (tag, key, shapes captured,
capture seconds, kernel nodes, the port's kernels in it, pool growth, eager
and replay ms). The graphs are dropped at the end of each phase. Launch
counts are launches that ran: the kernels' counters count those issued from
Python (eager code, and the first call of each program, which runs
eagerly; a capture records launches and counts none), `graph_launches`
those that replays ran.

It imports nothing of the JAX package, and exits non-zero without
printing a result when no card is available.
"""

import json
import random
import subprocess
import sys
import time

import torch


T_START = time.perf_counter()


def line(obj):
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - T_START, 1)}
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


if not torch.cuda.is_available():
    fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")

import numpy as np  # noqa: E402

from celo_bls_snark_tpu_torch import bench  # noqa: E402
from celo_bls_snark_tpu_torch import entry as port_entry  # noqa: E402
from celo_bls_snark_tpu_torch.batch import (  # noqa: E402
    SECURITY_BOUND,
    byte_count_from_target_batch_size,
)
from celo_bls_snark_tpu_torch.convert import tree_to_numpy  # noqa: E402
from celo_bls_snark_tpu_torch.hash_to_curve.try_and_increment_cip22 import (  # noqa: E402
    TryAndIncrementCIP22,
    composite_hash_to_g1_cip22,
)
from celo_bls_snark_tpu_torch.hashers.composite import (  # noqa: E402
    composite_hasher,
    crh_parameters,
)
from celo_bls_snark_tpu_torch.hashers.direct import DirectHasher  # noqa: E402
from celo_bls_snark_tpu_torch.hostmath import bw6 as hbw6  # noqa: E402
from celo_bls_snark_tpu_torch.hostmath import curves as hc  # noqa: E402
from celo_bls_snark_tpu_torch.hostmath.params import G1_GENERATOR, G2_GENERATOR, R  # noqa: E402
from celo_bls_snark_tpu_torch.keys import SIG_DOMAIN  # noqa: E402
from celo_bls_snark_tpu_torch.ops import curve as dc  # noqa: E402
from celo_bls_snark_tpu_torch.ops import field as F  # noqa: E402
from celo_bls_snark_tpu_torch.ops import hash_to_g1  # noqa: E402
from celo_bls_snark_tpu_torch.ops import kernels  # noqa: E402
from celo_bls_snark_tpu_torch.ops import msm  # noqa: E402
from celo_bls_snark_tpu_torch.ops import ntt as dntt  # noqa: E402
from celo_bls_snark_tpu_torch.ops import tower as TT  # noqa: E402
from celo_bls_snark_tpu_torch.parallel import distributed as pdist  # noqa: E402
from celo_bls_snark_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from celo_bls_snark_tpu_torch.scripts import bench_hash_verify as hash_bench  # noqa: E402
from celo_bls_snark_tpu_torch.scripts import bench_msm_ntt as prover  # noqa: E402
from celo_bls_snark_tpu_torch.scripts import bench_strategies as strategies  # noqa: E402
from celo_bls_snark_tpu_torch.scripts import prof_field  # noqa: E402
from celo_bls_snark_tpu_torch.relations.r1cs import ConstraintSystem  # noqa: E402
from celo_bls_snark_tpu_torch.snark import api  # noqa: E402
from celo_bls_snark_tpu_torch.snark import groth16 as g16  # noqa: E402
from celo_bls_snark_tpu_torch.snark import serialize_bw6  # noqa: E402
from celo_bls_snark_tpu_torch.snark.accel import DeviceAccel, get_accel  # noqa: E402
from celo_bls_snark_tpu_torch.snark.api import BW6_761_ENGINE  # noqa: E402
from celo_bls_snark_tpu_torch.snark.fixtures import generate_test_data  # noqa: E402
from celo_bls_snark_tpu_torch.snark.hash_to_bits_circuit import HashToBits  # noqa: E402
from celo_bls_snark_tpu_torch.utils import aotcache, profiling  # noqa: E402
from celo_bls_snark_tpu_torch.utils.bits import (  # noqa: E402
    bits_le_to_bytes_le,
    bytes_le_to_bits_le,
)
from celo_bls_snark_tpu_torch.utils.profiling import time_ms  # noqa: E402
from celo_bls_snark_tpu_torch.utils.rngs import XorShiftRng  # noqa: E402
from celo_bls_snark_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

DEV = torch.device("cuda:0")
SPECS = {17: F.FR, 25: F.FQ, 49: F.FQ761}
WIDTHS = [1, 127, 128, 4099, 1 << 20]
# H100 SXM published peaks: 3.35 TB/s HBM; 67 TFLOP/s float32 outside the
# tensor cores = 132 SMs x 128 FP32 lanes x 2 flops x 1.98 GHz, i.e. 33.5e12
# FP32 lane instructions per second. The published table gives no 32-bit
# integer rate; the INT32 pipe has 64 lanes per SM, half the FP32 lanes, so
# the FP32 lane rate is a ceiling the kernels' integer operations cannot
# exceed, and the bound it gives is a lower bound on their time
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 67e12 / 2
TENSOR_INT8_OPS_PER_S = 1979e12  # published dense 8-bit integer rate
SRC = "celo_bls_snark_tpu_torch/csrc/"
KERNEL_INFO = {
    "mont_mul": {"source": SRC + "field.cu",
                 "replaces": "celo_bls_snark_tpu/ops/field.py:252"},
    "mont_redc": {"source": SRC + "field.cu",
                  "replaces": "celo_bls_snark_tpu/ops/field.py:479"},
    "mont_mul_tc": {"source": SRC + "field_tc.cu",
                    "replaces": "celo_bls_snark_tpu/ops/field.py:323"},
    "mont_mul_shape": {"source": SRC + "field.cu",
                       "replaces": "scripts/prof_field.py:28"},
    "f12_cyclo_sq": {"source": SRC + "cyclo_sq.cu",
                     "replaces": "no TPU kernel: ops/tower.py's composition "
                                 "f12_cyclo_sq_plain (one mont_mul launch and "
                                 "118 PyTorch launches)"},
    "f12_mul": {"source": SRC + "f12_mul.cu",
                "replaces": "no TPU kernel: ops/tower.py's composition "
                            "f12_mul_plain (one mont_mul launch and 244 "
                            "PyTorch launches)"},
}
NO_LIBRARY = ("no PyTorch call computes a multi-precision Montgomery "
              "product or reduction")
PLAIN = {"mont_mul": F._mul_words_plain, "mont_redc": F._redc_words_plain,
         "mont_mul_tc": F._mul_tc_plain, "mont_mul_shape": F._mul_words_plain}
# (n, B) timed per kernel: the widths the paths launch. Verification: the
# fold's complete adds (6 x 2048 lanes), to_affine's inversion and the
# Miller loop's infinity tests (2), the pairing's Fq12 products at batch 2
# (54 x 2), f12_is_one (12 x 1). Prover: the NTT stages (n = 25 and 17 at
# 2^19), pointwise products and to_raw (2^20, n = 17), the Pippenger suffix
# rounds (2^15 lanes at n = 49) and the madd's two stacked layers (5 and
# 6 x 2^15), the batch inversion's products and zero test (n = 49 at 2^20).
# Hashing at 16,384 messages: round 1's exponentiation and Legendre zero
# test (5 counters x 16,384 lanes), the cofactor multiply's complete adds
# (6 x 16,384), the Tonelli-Shanks table matches (to_raw at 16,384), the
# Pedersen CRH's mixed adds (4 x 8 chunk lanes x 16,384). Strategies at
# 300 x 20: the individual strategy's Miller doubling step (6 Fq2 products,
# 18 x 24,000 lanes) and its 12,000 f12_is_one zero tests (12 x 12,000)
L_MSM = 1 << 15
L_H2G = 16384
L_STRAT = 24000
TIMED = {
    "mont_mul": [(25, 2), (25, 108), (25, 12288), (25, 1 << 16), (25, 1 << 19),
                 (25, 1 << 20), (17, 1 << 19), (49, L_MSM), (49, 5 * L_MSM),
                 (49, 6 * L_MSM), (49, 1 << 20), (25, 5 * L_H2G), (25, 6 * L_H2G),
                 (25, 32 * L_H2G), (25, 18 * L_STRAT)],
    "mont_redc": [(25, 2), (25, 12), (25, 1 << 20), (17, 1 << 20), (49, 1 << 20),
                  (25, L_H2G), (25, 5 * L_H2G), (25, 6 * L_STRAT)],
    "mont_mul_tc": [(25, 1 << 19), (25, 1 << 20), (17, 1 << 19), (49, L_MSM),
                    (49, 5 * L_MSM), (49, 6 * L_MSM), (49, 1 << 20)],
}
MAIN_WIDTH = {"mont_mul": (25, 12288), "mont_redc": (25, 2),
              "mont_mul_tc": (49, 6 * L_MSM), "f12_cyclo_sq": (25, 1),
              "f12_mul": (25, 33)}
# the final exponentiation's lanes: the grouped check (1), the strict and
# individual strategies (300, 6,000); and a width where the bytes bind
CYCLO_WIDTHS = [1, 300, 6000, 1 << 16]
# the Fq12 multiply's lanes: the final exponentiation's and the tree
# product's (1, 300, 6,000), the Miller loops' squarings (2, 33, 600,
# 12,000)
F12_MUL_WIDTHS = [1, 33, 300, 600, 6000, 12000]
SHAPE_B = 1 << 16  # the launch-shape sweep's width, n = 25


def bound(name, n, B):
    """(bound_ms, bound_by) for one launch over B lanes: the larger of
    bytes / HBM rate (inputs read once, output written once) and
    operations / peak rate, whatever implements the work. The card
    multiplies 32 x 32 bits, so per lane a Montgomery multiply is
    2 W^2 word products, W = ceil(n / 2) (A B and m p), each a low and a
    high half: 4 W^2 32-bit multiply instructions for mont_mul and
    mont_mul_shape (the same body), half of that for mont_redc (W^2 word
    products: m p alone), at the FP32 lane-instruction rate (a ceiling on
    the integer rate). mont_mul_tc keeps one of the two products
    on the CUDA cores (2 W^2) and does 2 (2n 2n + 4n 2n) = 24 n^2 8-bit
    operations on the tensor cores; its operations time is the larger of
    the two. f12_cyclo_sq reads 12 coefficients and writes 12 (96 n bytes
    a lane) and runs 30 mont_mul products a lane; f12_mul reads 24 and
    writes 12 (144 n bytes; f12_sq, its square, reads 12) and runs 54."""
    W = (n + 1) // 2
    if name == "f12_cyclo_sq":
        nbytes, t_ops = 96 * n * B, 30 * 4 * W * W * B / LANE_OPS_PER_S
    elif name in ("f12_mul", "f12_sq"):
        nbytes = (144 if name == "f12_mul" else 96) * n * B
        t_ops = 54 * 4 * W * W * B / LANE_OPS_PER_S
    elif name == "mont_redc":
        nbytes, t_ops = 8 * n * B, 2 * W * W * B / LANE_OPS_PER_S
    elif name == "mont_mul_tc":
        nbytes = 12 * n * B
        t_ops = max(2 * W * W * B / LANE_OPS_PER_S,
                    24 * n * n * B / TENSOR_INT8_OPS_PER_S)
    else:
        nbytes, t_ops = 12 * n * B, 4 * W * W * B / LANE_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


N_EDGE = 9  # the edge lanes of lazy_batch


def lazy_batch(spec, B, gen):
    """Random lazy [n, B] int32 limbs on the card: a value v0 < 2^(16(n-2))
    < p plus s p with s in [-255, 255], its limbs then re-split with random
    signed carries (value kept). When B > N_EDGE the first lanes hold the
    edges: 0, 1 and p - 1 as canonical limbs; v0 + 255p and v0 - 255p (the
    budget's ends) with signed carries; 255p + 1 and 256p - 1 as canonical
    limbs, whose top limb is nonzero, and their negatives with a negative
    top limb."""
    n, p = spec.n, spec.modulus
    lo = torch.randint(0, 1 << 16, (n, B), generator=gen, device=DEV)
    lo[n - 2:] = 0
    s = torch.randint(-255, 256, (1, B), generator=gen, device=DEV)
    if B > N_EDGE:
        s[0, 3], s[0, 4] = 255, -255
    limbs = lo + s * spec.column(spec.p_limbs, DEV, torch.int64)
    d = torch.randint(-512, 512, (n - 1, B), generator=gen, device=DEV)
    limbs[:-1] += d << 16
    limbs[1:] -= d
    if B > N_EDGE:
        top = [255 * p + 1, 256 * p - 1]
        assert all(v >> (16 * (n - 1)) for v in top)
        neg = [F.int_to_limbs((-v) % (1 << (16 * n)), n).astype("int64") for v in top]
        for v in neg:
            v[n - 1] -= 1 << 16  # two's complement: the top limb carries the sign
        cols = [F.int_to_limbs(v, n) for v in (0, 1, p - 1)]
        cols = {0: cols[0], 1: cols[1], 2: cols[2],
                5: F.int_to_limbs(top[0], n), 6: F.int_to_limbs(top[1], n),
                7: neg[0], 8: neg[1]}
        for lane, col in cols.items():
            limbs[:, lane] = torch.as_tensor(col, device=DEV)
    assert int(limbs.abs().max()) < (1 << 26)
    return limbs.to(torch.int32).contiguous()


def check_model(spec, a, b, out, lanes=24):
    """Python-int model on the first lanes: mul -> (A B + m p) / R and
    redc -> (X + m p) / R, A = a + 256p; canonical limbs, value < 2p."""
    n, p = spec.n, spec.modulus
    R = 1 << (16 * n)
    pinv = pow(p, -1, R)
    a, out = a.cpu().numpy(), out.cpu().numpy()
    b = None if b is None else b.cpu().numpy()
    for j in range(min(lanes, a.shape[1])):
        X = F.limbs_to_int(a[:, j]) + F.LAZY_P_BUDGET * p
        if b is not None:
            X *= F.limbs_to_int(b[:, j]) + F.LAZY_P_BUDGET * p
        want = (X + ((-X * pinv) % R) * p) // R
        if not (want < 2 * p and F.limbs_to_int(out[:, j]) == want
                and out[:, j].min() >= 0 and out[:, j].max() < 1 << 16):
            fail(f"{spec.name} lane {j}: kernel output disagrees with the model")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip(), flush=True)
    info = kernels.build()
    regs = kernels.ptxas_report(info["ptxas"])
    sass = kernels.sass()
    imma = kernels.sass_count("IMMA", sass)  # the integer tensor-core instruction
    if imma == 0:
        fail("the built library holds no IMMA instruction: mont_mul_tc "
             "does not reach the tensor cores")
    # the 32 x 32 -> 64 multiply-add with carry in and out
    wide = kernels.sass_count("IMAD.WIDE.U32.X", sass)
    if wide == 0:
        fail("the built library holds no IMAD.WIDE.U32.X instruction: the "
             "multiplies do not run as carry chains of 32-bit words")
    spilled = {k: v for k, v in regs.items()
               if v.get("spill_stores") or v.get("spill_loads")}
    if spilled:
        fail(f"ptxas reports register spills: {spilled}")
    occupancy = {n: kernels.tc_occupancy(n) for n in SPECS}
    if occupancy[49]["blocks_per_sm"] < 2:
        fail(f"mont_mul_tc<49> runs one block an SM: {occupancy[49]}")
    line({"phase": "device", "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "build_s": info["seconds"], "built": info["built"],
          "library": info["path"], "sources": [f.name for f in kernels.sources()],
          "sass_imma_instructions": "not measured" if imma is None else imma,
          "sass_imad_wide_u32_x_instructions":
              "not measured" if wide is None else wide,
          "sass_instructions": {
              k: v["instructions"]
              for k, v in (kernels.sass_histogram(sass) if sass else {}).items()},
          "mont_mul_tc_occupancy": occupancy,
          "ptxas": regs})
    return smi.stdout.strip()


def max_err(got, want):
    return int((got.long() - want.long()).abs().max())


def phase_kernels():
    gen = torch.Generator(device=DEV)
    gen.manual_seed(20261016)
    worst = {name: 0 for name in PLAIN}

    def hold(name, what, got, want):
        err = max_err(got, want)
        worst[name] = max(worst[name], err)
        if err:
            fail(f"{name} {what}: max |kernel - plain| = {err}")

    checked = 0
    for n, spec in SPECS.items():
        for B in WIDTHS:
            a, b = lazy_batch(spec, B, gen), lazy_batch(spec, B, gen)
            got, want = F.mont_mul(spec, a, b), F._mul_words_plain(spec, a, b)
            hold("mont_mul", f"n={n} B={B}", got, want)
            hold("mont_mul", f"n={n} B={B} against the 16-bit-radix plain version",
                 got, F._mul_plain(spec, a, b))
            got_r = F.mont_redc(spec, a)
            hold("mont_redc", f"n={n} B={B}", got_r, F._redc_words_plain(spec, a))
            hold("mont_redc", f"n={n} B={B} against the 16-bit-radix plain version",
                 got_r, F._redc_plain(spec, a))
            got_tc = F.mont_mul_tc(spec, a, b)
            hold("mont_mul_tc", f"n={n} B={B}", got_tc, F._mul_tc_plain(spec, a, b))
            hold("mont_mul_tc", f"n={n} B={B} against mont_mul", got_tc, got)
            if n == 25:
                for th in kernels.SHAPE_THREADS:
                    got_s = F.mont_mul_shape(spec, a, b, th)
                    hold("mont_mul_shape", f"threads={th} B={B}", got_s, want)
                    hold("mont_mul_shape", f"threads={th} B={B} against mont_mul",
                         got_s, got)
            if B == 127:
                check_model(spec, a, b, got)
                check_model(spec, a, b, got_tc)
                check_model(spec, a, None, got_r)
            checked += 1
    torch.cuda.synchronize()
    line({"phase": "kernels_exact", "cases": checked, "max_abs_err": worst,
          "widths": WIDTHS, "limbs": list(SPECS),
          "shape_threads": list(kernels.SHAPE_THREADS)})

    def timed_row(name, spec, B, call, plain_call, extra=()):
        hold(name, f"n={spec.n} B={B} (timed inputs)", call(), plain_call())
        iters = 200 if B < 100000 else 20
        bms, by = bound(name, spec.n, B)
        return {"n": spec.n, "B": B, **dict(extra), "max_abs_err": 0,
                "ms": time_ms(call, iters, graph=True),
                "eager_ms": time_ms(call, iters),
                "plain_ms": time_ms(plain_call, 3 if B > 100000 else 20),
                "bound_ms": bms, "bound_by": by}

    rows = {}
    for name, shapes in TIMED.items():
        kern = {"mont_mul": F.mont_mul, "mont_redc": F.mont_redc,
                "mont_mul_tc": F.mont_mul_tc}[name]
        rows[name] = []
        for n, B in shapes:
            spec = SPECS[n]
            a, b = lazy_batch(spec, B, gen), lazy_batch(spec, B, gen)
            args = (a,) if name == "mont_redc" else (a, b)
            rows[name].append(timed_row(
                name, spec, B, lambda: kern(spec, *args),
                lambda: PLAIN[name](spec, *args)))
    a, b = lazy_batch(F.FQ, SHAPE_B, gen), lazy_batch(F.FQ, SHAPE_B, gen)
    rows["mont_mul_shape"] = [
        timed_row("mont_mul_shape", F.FQ, SHAPE_B,
                  lambda th=th: F.mont_mul_shape(F.FQ, a, b, th),
                  lambda: PLAIN["mont_mul_shape"](F.FQ, a, b),
                  extra={"threads": th}.items())
        for th in kernels.SHAPE_THREADS
    ]
    return rows, worst


def lazy_f12(B, gen):
    """An Fq12 batch on the card as the final exponentiation's squarings
    take it: 12 lazy [25, B] coefficients, each a value v0 < 2^(16 (n - 2))
    plus s p with s in [-8, 8], its limbs re-split with random signed
    carries below 2^6 (limbs below 2^23, so that every pre-added operand
    stays inside the multiply's contract)."""
    spec, n = F.FQ, F.FQ.n
    leaves = []
    for _ in range(12):
        lo = torch.randint(0, 1 << 16, (n, B), generator=gen, device=DEV)
        lo[n - 2:] = 0
        s = torch.randint(-8, 9, (1, B), generator=gen, device=DEV)
        limbs = lo + s * spec.column(spec.p_limbs, DEV, torch.int64)
        d = torch.randint(-64, 64, (n - 1, B), generator=gen, device=DEV)
        limbs[:-1] += d << 16
        limbs[1:] -= d
        leaves.append(limbs.to(torch.int32))
    return tuple(tuple((leaves[6 * h + 2 * k], leaves[6 * h + 2 * k + 1])
                       for k in range(3)) for h in range(2))


def f12_kernel_rows(name, widths, cases, seed):
    """An Fq12 kernel at `widths`, limb for limb against the composition it
    replaces on the card (its plain version on CUDA tensors) and, up to
    6,000 lanes, on the CPU; each timed from a replayed CUDA graph of 200
    launches (`ms`), issued from Python (`eager_ms`), beside the
    composition from a replayed graph (`plain_ms`) and the bound. `cases`:
    (op, operands, kernel, plain), op naming the bound. Returns (rows,
    max |err|)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    rows, worst = [], 0
    for B in widths:
        args = [lazy_f12(B, gen) for _ in range(max(c[1] for c in cases))]
        for op, k, kern_fn, plain_fn in cases:
            def kern(a=args[:k], fn=kern_fn):
                return fn(*a)

            def plain(a=args[:k], fn=plain_fn):
                return fn(*a)

            got = torch.stack(tree_leaves(kern()))
            err = max_err(got, torch.stack(tree_leaves(plain())))
            if B <= 6000:
                cpu = plain_fn(*(tree_map(lambda t: t.cpu(), a) for a in args[:k]))
                err = max(err, max_err(got.cpu(), torch.stack(tree_leaves(cpu))))
            if err:
                fail(f"{name} ({op}) B={B}: max |kernel - plain| = {err}")
            worst = max(worst, err)
            bms, by = bound(op, F.FQ.n, B)
            rows.append({"op": op, "n": F.FQ.n, "B": B, "max_abs_err": err,
                         "ms": time_ms(kern, 200, graph=True),
                         "eager_ms": time_ms(kern, 200),
                         "plain_ms": time_ms(plain, 20, graph=True),
                         "bound_ms": bms, "bound_by": by})
    return rows, worst


def phase_cyclo_sq():
    """The cyclotomic squaring's kernel (csrc/cyclo_sq.cu) at the final
    exponentiation's widths and at 2^16 lanes (f12_kernel_rows; its
    composition is one mont_mul launch and 118 PyTorch launches). One
    `cyclo_sq` line; returns (rows, max |err|)."""
    rows, worst = f12_kernel_rows(
        "f12_cyclo_sq", CYCLO_WIDTHS,
        [("f12_cyclo_sq", 1, TT.f12_cyclo_sq, TT.f12_cyclo_sq_plain)], 20261021)
    line({"phase": "cyclo_sq", "rows": rows,
          "card": torch.cuda.get_device_name(0)})
    return rows, worst


def phase_f12_mul():
    """The Fq12 multiply's kernel (csrc/f12_mul.cu), a product of two
    batches and a square (one operand, read once), at the pairing's widths
    (f12_kernel_rows; its composition is one mont_mul launch and 244
    PyTorch launches). One `f12_mul` line; returns (rows, max |err|)."""
    rows, worst = f12_kernel_rows(
        "f12_mul", F12_MUL_WIDTHS,
        [("f12_mul", 2, TT.f12_mul, TT.f12_mul_plain),
         ("f12_sq", 1, TT.f12_sq, lambda a: TT.f12_mul_plain(a, a))], 20261022)
    line({"phase": "f12_mul", "rows": rows,
          "card": torch.cuda.get_device_name(0)})
    return rows, worst


def double_lane(pt, lane=0):
    """Replace one lane of a G1 projective batch by its double: still a
    subgroup point, but no longer the signature (or aggregate) it was."""
    doubled = dc.g1.double(tree_map(lambda x: x[:, lane:lane + 1], pt))
    return tree_map(lambda d, x: torch.cat([x[:, :lane], d, x[:, lane + 1:]], dim=-1),
                    doubled, pt)


def phase_entry():
    fn, args = port_entry.entry(device="cuda")
    st = port_entry.verify_stages(*args)
    if not bool(st["ok"][0]):
        fail("entry(): verification on the card returned False")
    bad = (double_lane(args[0]),) + tuple(args[1:])
    if bool(fn(*bad)[0]):
        fail("entry(): tampered batch verified True on the card")
    cpu_args = port_entry.example_inputs(device="cpu")
    cpu = port_entry.verify_stages(*cpu_args)
    card = tree_leaves(tree_to_numpy(st["final_exp"]))
    host = tree_leaves(tree_to_numpy(cpu["final_exp"]))
    equal = all((x == y).all() for x, y in zip(card, host))
    if not equal or not bool(cpu["ok"][0]):
        fail("entry(): the card's final-exp output differs from the CPU run")
    line({"phase": "entry", "messages": 8, "validators": 4, "ok": True,
          "tampered_ok": False, "final_exp_equal_cpu": True})


def stage_breakdown(sigs, hashes, apk):
    """One verification through ops/bls.py's own pipeline, stage by stage
    (synchronized host clock around each): seconds and kernel launches per
    stage, and the pipeline's outputs."""
    times = {}

    def stage(name, fn):
        F.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = {"s": time.perf_counter() - t0, **launch_counts()}
        return out

    st = bench.dbls.batch_verify_grouped_stages(sigs, hashes, apk, 1, stage=stage)
    if not bool(st["ok"][0]):
        fail("main path: the stage-by-stage verification returned False")
    return times, st


def launch_counts():
    return {k.name: k.launches for k in F.KERNELS}


def run_launches():
    """The port's kernel launches that ran since reset_counts(): those
    issued from Python plus those that graph replays ran."""
    replayed = aotcache.graph_launches()
    return {k: v + replayed.get(k, 0) for k, v in launch_counts().items()}


def launch_counts_by_n():
    return {k.name: dict(sorted(k.launches_by_n.items())) for k in F.KERNELS}


def reset_counts():
    """Every launch count to 0: the kernels' counters and the graphs'
    replay counts."""
    F.reset_launches()
    aotcache.reset_replays()


def event_ms(fn, n=1):
    """fn() n times between two CUDA events: (the last output, ms a call)."""
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(n):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1) / n


def same_leaves(a, b):
    a, b = tree_leaves(a), tree_leaves(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


_CALLS = {}  # (tag, mul) -> (size, AotJit, args): each program's largest call


def record_calls():
    """Have every AotJit call on the card keep its arguments, those of the
    largest call per program and multiply, for graph_lines."""
    call = aotcache.AotJit.__call__

    def recorded(self, *args):
        ts = [x for x in tree_leaves(args) if isinstance(x, torch.Tensor)]
        if ts and ts[0].is_cuda:
            k, size = (self.tag, F.selected_mul().name), sum(t.numel() for t in ts)
            if k not in _CALLS or size > _CALLS[k][0]:
                _CALLS[k] = (size, self, args)
        return call(self, *args)

    aotcache.AotJit.__call__ = recorded


def graph_lines(phase):
    """Every program called on the card since the last check, under the
    field multiply selected now, on the arguments of its largest call: the
    program's graph (captured now if the path did not capture it) replays
    equal to its function run eagerly, leaf for leaf, and both are timed
    between CUDA events on those arguments (the mean of 5 calls where one
    eager call takes under 50 ms). One `graph` line a program, with the
    number of shapes captured; each capture's own line is on stderr
    ([aot] MISS)."""
    mul = F.selected_mul().name
    todo = [(k[0], v[1], v[2]) for k, v in _CALLS.items() if k[1] == mul]
    for tag, jit, args in todo:
        eager, eager_ms = event_ms(lambda: jit.fn(*args))
        n = 5 if eager_ms < 50 else 1
        if n > 1:
            eager, eager_ms = event_ms(lambda: jit.fn(*args), n)
        captured_by_path = aotcache._arg_key(args) in jit.entries
        e = jit.prepare(*args)
        graph, replay_ms = event_ms(lambda: jit(*args), n)
        key = aotcache.key_str(e.key)
        if not same_leaves(eager, graph):
            fail(f"graph {tag} at {key}: the replay differs from the eager run")
        line({"graph": tag, "key": key, "phase_of": phase,
              "shapes": sum(x.mul == mul for x in jit.entries.values()),
              "captured_by_path": captured_by_path, **e.info,
              "eager_ms": eager_ms, "replay_ms": replay_ms, "calls_timed": n,
              "equal_eager": True})
    for k in [k for k in _CALLS if k[1] == mul]:
        del _CALLS[k]


def drop_graphs(phase):
    """The phase's graphs, with their shared pool, freed: one line with the
    pool's growth summed over the captures and the card's peak
    allocation."""
    es = aotcache.entries()
    line({"phase": f"graphs_{phase}", "graphs": len(es),
          "pool_bytes": sum(e.info["pool_bytes"] for e in es),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "memory_reserved": torch.cuda.memory_reserved()})
    aotcache.clear()
    _CALLS.clear()
    torch.cuda.empty_cache()


def busy_profile(fn):
    """One call of fn under utils/profiling.py's device_trace: wall time,
    the summed time of all kernels on the card and its share of the wall,
    kernel count, the port's own kernels and the kernels that took the most
    device time. Only the card's activity is traced unless
    CELO_BLS_TPU_PROFILE_TRACE_DIR asks for a Chrome trace: host events
    would add a hundred thousand records to sort for numbers this line does
    not print."""
    t_all = time.perf_counter()
    torch.cuda.synchronize()
    with profiling.device_trace() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    rows = lambda es: [{"name": e.key[:60], "count": e.count,  # noqa: E731
                        "device_s": e.self_device_time_total / 1e6} for e in es]
    return {
        "port_kernels": rows(e for e in kern if "mont_" in e.key),
        "wall_s": wall,
        "device_busy_s": busy_us / 1e6 if busy_us else "not measured",
        "device_busy_share": busy_us / 1e6 / wall if busy_us else "not measured",
        "kernel_launches": sum(e.count for e in kern),
        "top_kernels": rows(top),
        "profile_s": time.perf_counter() - t_all,
        "note": "profiled run; the profiler adds host time per launch",
    }


def phase_main(n_messages=524288, n_validators=100, n_iter=2,
               n_seed=bench.N_SEED):
    t0 = time.perf_counter()
    sigs, hashes, apk = bench.build_inputs(n_messages, n_validators,
                                           device=DEV, n_seed=n_seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the main path through the benchmark's entry point, with the launch
    # counts set to 0 just before and read just after exactly this run
    # (its eager run, and its capture and first replay)
    reset_counts()
    t0 = time.perf_counter()
    bench.warm_up(sigs, hashes, apk)
    warm_s = time.perf_counter() - t0
    launches = run_launches()
    for name in ("mont_mul", "mont_redc"):
        if launches[name] <= 0:
            fail(f"main path: kernel {name} was not launched")
    (graph,) = [e for e in aotcache.entries() if e.jit.tag == "bls_grouped_1"]
    stages, state = stage_breakdown(sigs, hashes, apk)
    # host check of the P legs: lane k*N_SEED + i holds (k+1) H_i, so the
    # hash sum is T * sum(H) with T = tiles (tiles + 1) / 2
    seeds, _apk, sk_sum = bench.host_inputs(n_validators, n_seed=n_seed)
    tiles = n_messages // n_seed
    hsum = hc.G1.mul(tiles * (tiles + 1) // 2, hc.G1.msum(seeds))
    want = [hc.G1.mul(sk_sum, hsum), hsum]
    xs, ys = (F.FQ.unpack(v) for v in state["p_aff"])
    if list(zip(xs, ys)) != want:
        fail("main path: the affine P legs differ from the host's")
    # the staged pipeline as a graph: every stage's limbs, final_exp
    # included (its first call runs eagerly, the second replays the graph)
    staged = aotcache.jit("bls_grouped_stages_1", lambda s, h, pk: tuple(
        bench.dbls.batch_verify_grouped_stages(s, h, pk, 1).values()))
    for _ in range(2):
        if not same_leaves(staged(sigs, hashes, apk), tuple(state.values())):
            fail("main path: the staged pipeline's graph differs from its eager run")
    if next(iter(staged.entries.values())).replays != 1:
        fail("main path: the staged pipeline did not replay its graph")
    if bool(bench.verify(double_lane(sigs), hashes, apk)[0]):
        fail("main path: tampered batch verified True through the graph")
    metric = bench.timed(n_messages, sigs, hashes, apk, n_iter=n_iter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        ok = bench.dbls.batch_verify_grouped_device(sigs, hashes, apk, 1)
    torch.cuda.synchronize()
    eager_s = (time.perf_counter() - t0) / n_iter
    if not bool(ok[0]):
        fail("main path: the eager verification returned False")
    metric.update(eager_seconds_per_verify=eager_s, eager_value=n_messages / eager_s,
                  graph=True)
    line({"phase": "main_path_stages", **stages})
    line({"phase": "main_path_profile", "replayed_graph": True,
          **busy_profile(lambda: bench.verify(sigs, hashes, apk))})
    graph_lines("main_path")
    line({"phase": "main_path", "messages": n_messages,
          "validators": n_validators, "groups": 1, "input_build_s": build_s,
          "warmup_s": warm_s, "launches": launches,
          "launches_note": "the warm-up's launches that ran: its eager run "
                           "and its first replay",
          "launches_per_verify": graph.info["port_kernels"],
          "launches_per_verify_from": "the graph's capture",
          "timed_verifications": n_iter, "final_exp_graph_equal_eager": True,
          "p_aff_equal_host": True, "tampered_ok": False})
    line(metric)
    drop_graphs("main_path")
    return launches, (sigs, hashes, apk)


def require_path_kernels(path, launches):
    """The path's own kernels ran, and no other multiply did."""
    for name in ("mont_mul", "mont_redc"):
        if launches[name] <= 0:
            fail(f"{path}: kernel {name} was not launched")
    if launches["mont_mul_tc"] or launches["mont_mul_shape"]:
        fail(f"{path}: unexpected launch counts {launches}")


def phase_hash_verify(n_messages=16384, n_validators=100, n_iter=2,
                      n_sample=256, seed=20261017):
    """Hashing-included batch verification at the JAX bench's
    configuration, through ops/bls.py::batch_verify_messages_device, for
    the DirectHasher and the composite CRH. Returns the launches of the two
    warm-up verifications."""
    t0 = time.perf_counter()
    sk_sum, apk = hash_bench.committee(n_validators)
    apk_aff = bench.dbls.pack_g2_affine([apk], DEV)
    msgs = hash_bench.messages(n_messages)
    committee_s = time.perf_counter() - t0
    total = {}
    for composite in (False, True):
        hasher_name = "composite" if composite else "direct"
        t0 = time.perf_counter()
        if composite:
            crh_parameters()  # the generator table, built once in Python
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sigs, hashes, fallback = hash_bench.signatures(sk_sum, msgs, composite, DEV)
        torch.cuda.synchronize()
        sign_s = time.perf_counter() - t0
        # the path, with the launch counts set to 0 just before and read
        # just after exactly this verification (every program's first call,
        # which runs eagerly)
        reset_counts()
        t0 = time.perf_counter()
        ok = bool(hash_bench.verify(sigs, apk_aff, msgs, composite)[0])
        warm_s = time.perf_counter() - t0
        launches = run_launches()
        warm_graph_launches = aotcache.graph_launches()
        if not ok:
            fail(f"hash_verify ({hasher_name}): the honest batch verified False")
        require_path_kernels(f"hash_verify ({hasher_name})", launches)
        add_launches(total, launches)
        # the lanes round 1 left to round 2: the hash at round 1's counters alone
        crh = hash_to_g1.composite_crh_bytes(msgs, DEV) if composite else None
        _, has1 = hash_to_g1.hash_to_g1_device(
            SIG_DOMAIN, msgs, b"", num_counters=hash_to_g1.ROUND1_COUNTERS,
            crh_u8=crh, device=DEV)
        round2 = sorted(set(np.nonzero(~has1)[0].tolist()) - set(fallback))
        sample = random.Random(seed).sample(range(n_messages), n_sample)
        lanes = sorted(set(sample) | set(round2) | set(fallback))
        t0 = time.perf_counter()
        idx = torch.tensor(lanes, device=DEV)
        got = dc.g1_unpack(tree_map(lambda x: x[:, idx], hashes))
        h2c = TryAndIncrementCIP22(composite_hasher() if composite else DirectHasher(),
                                   "g1", True)
        want = [h2c.hash(SIG_DOMAIN, msgs[i], b"") for i in lanes]
        host_s = time.perf_counter() - t0
        bad = [lanes[k] for k in range(len(lanes)) if got[k] != want[k]]
        if bad:
            fail(f"hash_verify ({hasher_name}): lanes {bad[:8]} differ from the "
                 f"host TryAndIncrementCIP22 ({len(bad)} of {len(lanes)})")
        # the second call of the path's programs: captured and replayed
        if bool(hash_bench.verify(double_lane(sigs), apk_aff, msgs, composite)[0]):
            fail(f"hash_verify ({hasher_name}): the tampered batch verified True")
        if not any(e.jit.tag == "bls_grouped_1" and e.replays for e in aotcache.entries()):
            fail(f"hash_verify ({hasher_name}): the tampered batch did not replay "
                 "the pairing check's graph")
        reset_counts()
        metric = hash_bench.timed(sigs, apk_aff, msgs, composite, n_iter)
        timed_eager, replayed = launch_counts(), aotcache.graph_launches()
        per_verify = {k: (v + replayed.get(k, 0)) / n_iter for k, v in timed_eager.items()}
        if not composite:  # one profiled verification for the busy share
            line({"phase": "hash_verify_profile", "hasher": hasher_name,
                  "replayed_graphs": True,
                  **busy_profile(lambda: hash_bench.verify(sigs, apk_aff, msgs, False))})
        graph_lines(f"hash_verify {hasher_name}")
        line({"phase": "hash_verify", "hasher": hasher_name, "messages": n_messages,
              "validators": n_validators, "num_counters": hash_bench.NUM_COUNTERS,
              "compat": True, "committee_s": committee_s, "setup_s": setup_s,
              "sign_on_card_s": sign_s, "warmup_s": warm_s,
              "launches": launches, "graph_launches": warm_graph_launches,
              "launches_note": "the warm-up's launches that ran: eager code and "
                               "every program's first call (graph_launches: "
                               "replays, none in a first call)",
              "launches_per_verify": per_verify,
              "launches_per_verify_from": "the timed verifications (graph replays "
                                          "and eager code)",
              "ok": True, "tampered_ok": False,
              "host_checked_lanes": len(lanes), "host_checked_sample": n_sample,
              "host_checked_round2": len(round2), "host_check_s": host_s,
              "fallback_lanes": len(fallback), "equal_host": True})
        line(metric)
    drop_graphs("hash_verify")
    return total


def phase_strict_verify(n_epochs=300, n_validators=20, c=4, seed=20261018):
    """Strict per-epoch batch verification at scripts/bench_strategies.py's
    configuration: n_epochs epochs, the same n_validators validators
    signing every epoch, per-epoch extra_data, composite hashing on the
    card, Straus MSMs with windows of c bits over exponents of
    byte_count_from_target_batch_size(n_validators, 128) bytes. Returns the
    launches of the honest run."""
    G, V = n_epochs, n_validators
    rng = random.Random(seed)
    t0 = time.perf_counter()
    msgs = [b"block %06d" % g for g in range(G)]
    extras = [b"extra %04d" % g for g in range(G)]
    h2c = composite_hash_to_g1_cip22()
    # the signatures sign the HOST hashes, so a True verdict also holds the
    # card's hashes against the host's
    hs_host = [h2c.hash(SIG_DOMAIN, m, e) for m, e in zip(msgs, extras)]
    sks = [rng.randrange(1, R) for _ in range(V)]
    pk_jac = dc.g2_pack([hc.G2.mul(s, G2_GENERATOR) for s in sks] * G, DEV)
    skbits = torch.tensor([[(s >> (252 - b)) & 1 for s in sks] * G for b in range(253)],
                          dtype=torch.int32, device=DEV)
    h_per_val = dc.g1_pack([h for h in hs_host for _ in range(V)], DEV)
    sig_jac = dc.g1.scalar_mul_bits(skbits, h_per_val)
    nb = byte_count_from_target_batch_size(V, SECURITY_BOUND)
    digits = torch.from_numpy(msm.window_digits(
        [rng.randrange(1 << (8 * nb)) for _ in range(G * V)], 8 * nb, c)).to(DEV)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def strict(sigs):
        hashes, fallback = hash_to_g1.hash_messages_device(
            SIG_DOMAIN, msgs, extras, composite=True, num_counters=24, device=DEV)
        h_aff = dc.g1.to_affine(hashes)
        out = bench.dbls.strict_batch_verify_device(digits, sigs, pk_jac, h_aff, G, c)
        return out.cpu().tolist(), fallback

    reset_counts()
    t0 = time.perf_counter()
    res, fallback = strict(sig_jac)
    first_s = time.perf_counter() - t0
    launches = run_launches()
    if not all(res):
        fail(f"strict_verify: epochs {[g for g in range(G) if not res[g]][:8]} False")
    require_path_kernels("strict_verify", launches)
    bad_epoch = rng.randrange(G)
    lane = bad_epoch * V + rng.randrange(V)
    bad = tree_map(lambda d, x: torch.cat([x[:, :lane], d, x[:, lane + 1:]], dim=-1),
                   dc.g1.double(tree_map(lambda x: x[:, lane:lane + 1], sig_jac)),
                   sig_jac)
    res_bad, _ = strict(bad)
    if res_bad != [g != bad_epoch for g in range(G)]:
        fail(f"strict_verify: a bad signature in epoch {bad_epoch} gave False at "
             f"{[g for g in range(G) if not res_bad[g]][:8]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strict(sig_jac)
    timed_s = time.perf_counter() - t0
    line({"phase": "strict_verify", "epochs": G, "validators": V, "c": c,
          "exponent_bytes": nb, "hashing": "composite", "setup_s": setup_s,
          "first_s": first_s, "seconds": timed_s, "epochs_per_s": G / timed_s,
          "launches": launches, "fallback_lanes": len(fallback), "all_true": True,
          "bad_epoch": bad_epoch, "only_bad_epoch_false": True})
    graph_lines("strict_verify")
    drop_graphs("strict_verify")
    return launches, hs_host


def phase_strategies(hashes, card, n_blocks=300, n_validators=20, n_iter=2,
                     seed=20261021, n_sample=8):
    """The reference's four-strategy batch-BLS bench at its shape through
    scripts/bench_strategies.py's own functions: `hashes` are the host
    hashes of its block messages (strict_verify's). derive's first call
    (eager) makes the keys, signatures and aggregates on the card; they
    equal the host's at sampled lanes and blocks, and the total. Then per
    strategy, with the block hashing on the card in every call: a first
    call (eager) and a second (the capture) that are True, `n_iter` timed
    replays, the strategy's own tamper (False), and a compensating forgery
    (two signatures of one block shifted by +D and -D, the aggregates
    recomputed by derive's sums: screenings True, the others False).
    Returns the launches of the phase."""
    B, V = n_blocks, n_validators
    rnd = random.Random(seed)
    t0 = time.perf_counter()
    inp = strategies.build_inputs(B, V, seed, DEV, hashes=hashes)
    torch.cuda.synchronize()
    derive_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sks = inp["sks"]
    sums = [sum(sks[b * V:(b + 1) * V]) % R for b in range(B)]
    lanes = sorted(rnd.sample(range(B * V), n_sample))
    blocks = sorted(rnd.sample(range(B), n_sample))

    def at(tree, idx):
        return tree_map(lambda x: x[:, torch.tensor(idx, device=DEV)], tree)

    checks = {
        "pk": (dc.g2_unpack(at(inp["pk_jac"], lanes)),
               [hc.G2.mul(sks[j], G2_GENERATOR) for j in lanes]),
        "sig": (dc.g1_unpack(at(inp["sig_jac"], lanes)),
                [hc.G1.mul(sks[j], hashes[j // V]) for j in lanes]),
        "apk_b": (dc.g2_unpack(at(inp["apk_b"], blocks)),
                  [hc.G2.mul(sums[b], G2_GENERATOR) for b in blocks]),
        "asig_b": (dc.g1_unpack(at(inp["asig_b"], blocks)),
                   [hc.G1.mul(sums[b], hashes[b]) for b in blocks]),
        "asig": (dc.g1_unpack(inp["asig"]),
                 [hc.G1.msum([hc.G1.mul(k, h) for k, h in zip(sums, hashes)])]),
    }
    for what, (got, want) in checks.items():
        if got != want:
            fail(f"strategies: derived {what} differs from the host's")
    host_s = time.perf_counter() - t0
    names = list(strategies.ARGS)
    bad_lane = rnd.randrange(B * V)
    tamper = {names[0]: {"asig_b": double_lane(inp["asig_b"], rnd.randrange(B))},
              names[1]: {"asig": double_lane(inp["asig"])},
              names[2]: {"sig_jac": double_lane(inp["sig_jac"], bad_lane)},
              names[3]: {"sig_jac": double_lane(inp["sig_jac"], bad_lane)}}
    b0 = rnd.randrange(B)
    D = hc.G1.mul(rnd.randrange(1, R), G1_GENERATOR)
    shift = [None] * (B * V)
    shift[b0 * V], shift[b0 * V + 1] = D, hc.G1.neg(D)
    sig_forged = dc.g1.add(inp["sig_jac"], dc.g1_pack(shift, DEV))
    asig_b_forged, asig_forged = strategies.sig_sums(sig_forged, B)
    forged = {"sig_jac": sig_forged, "asig_b": asig_b_forged, "asig": asig_forged}
    screening = names[:2]
    total = {}

    def counted(fn):
        """fn() with the launch counts set to 0 just before and read just
        after: (its output, seconds, launches that ran), the launches also
        added to the phase's total."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        add_launches(total, run_launches())
        return out, dt, {"python_issued": launch_counts(),
                         "replayed": aotcache.graph_launches()}

    for name, fn in strategies.make_strategies(inp):
        torch.cuda.reset_peak_memory_stats()
        first, first_s, first_launches = counted(lambda: bool(fn()))
        require_path_kernels(f"strategies ({name})", first_launches["python_issued"])
        second, capture_s, _ = counted(lambda: bool(fn()))
        replays = []
        for _ in range(n_iter):
            ok, dt, timed = counted(lambda: bool(fn()))
            replays.append((ok, dt))
        tampered, _, _ = counted(lambda: bool(fn(**tamper[name])))
        forged_ok, _, _ = counted(lambda: bool(fn(**forged)))
        if not (first and second and all(ok for ok, _ in replays)):
            fail(f"strategies: {name!r} returned False on honest inputs")
        if tampered:
            fail(f"strategies: {name!r} returned True on its tamper")
        if forged_ok != (name in screening):
            fail(f"strategies: {name!r} returned {forged_ok} on the compensating "
                 f"forgery, expected {name in screening}")
        seconds = sum(dt for _, dt in replays) / n_iter
        line({"phase": "strategies", "strategy": name, "blocks": B, "validators": V,
              "ok": True, "tampered_ok": False, "forged_ok": forged_ok,
              "first_s": first_s, "capture_call_s": capture_s,
              "seconds": seconds, "messages_per_s": B / seconds, "replays_timed": n_iter,
              "first_call_launches": first_launches,
              "replay_call_launches": timed,
              "launches_note": "per kernel, issued from Python and replayed from "
                               "graphs; replay_call_launches: the last timed call",
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "card": card})
    line({"phase": "strategies_inputs", "blocks": B, "validators": V, "derive_s": derive_s,
          "host_check_s": host_s, "host_checked_lanes": lanes,
          "host_checked_blocks": blocks, "derived_equal_host": True,
          "forged_block": b0, "card": card})
    graph_lines("strategies")
    drop_graphs("strategies")
    return total


def g2_route_check(n_points=64, seed=20261019):
    """The BW6-761 G2 route of the setup and the prover on the card: a
    fixed-base batch of G2 generator multiples and an MSM over them with a
    cache key, against hostmath/bw6.py."""
    accel = get_accel("bw6_761", DEV)
    r = BW6_761_ENGINE.fr
    rnd = random.Random(seed)
    ks = [rnd.randrange(r) for _ in range(n_points - 1)] + [0]
    t0 = time.perf_counter()
    bases = accel.g2.fixed_base_batch(ks)
    got = list(bases)
    want = [hbw6.G2.mul(k, hbw6.G2_GENERATOR) if k else None for k in ks]
    if got != want:
        fail(f"epoch_snark: the BW6-761 G2 fixed-base batch differs from the "
             f"host at lanes {[i for i in range(n_points) if got[i] != want[i]][:8]}")
    ss = [rnd.randrange(r) for _ in ks]
    k = sum(a * b for a, b in zip(ks, ss)) % r
    want_msm = hbw6.G2.mul(k, hbw6.G2_GENERATOR) if k else None
    for _ in range(2):  # the second call reads the cached bases
        if accel.g2.msm(bases, ss, cache_key=("g2_route_check", seed)) != want_msm:
            fail("epoch_snark: the BW6-761 G2 MSM differs from the host")
    return {"g2_points": n_points, "g2_fixed_base_equal_host": True,
            "g2_msm_equal_host": True, "g2_check_s": time.perf_counter() - t0}


def phase_epoch_snark(n_validators=4, faults=1, n_transitions=2, order=()):
    """The epoch SNARK at the reference's e2e configuration through
    snark/api.py on the card: trusted_setup, prove, verify_parsed and the
    byte API; then the 2-SNARK helper over BLS12-377. Returns the launches
    of setup + prove of the epoch proof and of the helper's."""
    info = g2_route_check()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiling.reset()
    # the epoch path, with the launch counts set to 0 just before the
    # setup and read just after the proof
    sizes = {}
    generate_parameters = g16.generate_parameters

    def sized(cs, engine, rng, accel=None):  # records the circuit's size
        sizes.update(constraints=cs.num_constraints, instance=cs.num_instance)
        return generate_parameters(cs, engine, rng, accel=accel)

    g16.generate_parameters = sized
    reset_counts()
    t0 = time.perf_counter()
    try:
        params = api.trusted_setup(n_validators, n_transitions, faults,
                                   XorShiftRng(b"e2e-trusted-setp"), device="cuda")
    finally:
        g16.generate_parameters = generate_parameters
    setup_s = time.perf_counter() - t0
    setup_launches = run_launches()
    setup_stages = profiling.report()
    profiling.reset()
    t0 = time.perf_counter()
    first, transitions, last = generate_test_data(n_validators, faults, n_transitions)
    fixtures_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof = api.prove(params, n_validators, first, transitions,
                      max_transitions=n_transitions, device="cuda")
    prove_s = time.perf_counter() - t0
    launches = run_launches()
    by_n = launch_counts_by_n()
    replayed = aotcache.graph_launches()
    prove_stages = profiling.report()
    peak = torch.cuda.max_memory_allocated()
    if not by_n["mont_mul"].get(49) or not by_n["mont_mul"].get(25):
        fail(f"epoch_snark: mont_mul<49> and mont_mul<25> must both launch: {by_n}")
    require_path_kernels("epoch_snark", launches)
    vk = params.epochs.vk
    t0 = time.perf_counter()
    ok = api.verify_parsed(vk, first, last, proof)
    verify_s = time.perf_counter() - t0
    if not ok:
        fail("epoch_snark: the proof does not verify")
    if api.verify_parsed(vk, first, first, proof):
        fail("epoch_snark: the proof verifies against a tampered last epoch")
    if not api.verify(serialize_bw6.vk_to_bytes(vk), serialize_bw6.proof_to_bytes(proof),
                      first, last):
        fail("epoch_snark: the byte API rejects the serialized key and proof")
    # the prover's graphs captured for the key ahead of a proof, and a
    # second proof with the same key replaying every one of them (its MSMs
    # and h-polynomial): what a prover that proves epoch after epoch pays
    before = {id(e) for e in aotcache.entries()}
    t0 = time.perf_counter()
    get_accel("bw6_761", DEV).prewarm_prove(params.epochs, block=True)
    prewarm_s = time.perf_counter() - t0
    prewarmed = [e for e in aotcache.entries() if id(e) not in before]
    profiling.reset()
    aotcache.reset_replays()
    t0 = time.perf_counter()
    again = api.prove(params, n_validators, first, transitions,
                      max_transitions=n_transitions, device="cuda")
    prove_warm_s = time.perf_counter() - t0
    warm_stages = profiling.report()
    if again != proof:
        fail("epoch_snark: the second proof with the same key differs from the first")
    prewarm_replays = {f"{e.jit.tag} {aotcache.key_str(e.key)}": e.replays
                       for e in prewarmed}
    replayed_tags = {e.jit.tag for e in aotcache.entries() if e.replays}
    if min(prewarm_replays.values(), default=0) < 1 or "hp_bw6_761" not in replayed_tags \
            or not any(t.startswith("pip_bw6_g1") for t in replayed_tags):
        fail(f"epoch_snark: the second proof did not replay the prover's graphs: "
             f"prewarmed {prewarm_replays}, replayed {sorted(replayed_tags)}")
    pk = params.epochs
    stage_s = lambda rep: {k: v["total_s"] for k, v in rep.items()}  # noqa: E731
    line({"phase": "epoch_snark", "validators": n_validators, "faults": faults,
          "transitions": n_transitions, "two_snark": False,
          **sizes, "domain": len(pk.h_query) + 1,
          "variables": len(pk.a_query),
          "setup_s": setup_s, "fixtures_s": fixtures_s, "prove_s": prove_s,
          "verify_s": verify_s, "setup_stage_s": stage_s(setup_stages),
          "prove_stage_s": stage_s(prove_stages), "prewarm_block_s": prewarm_s,
          "prove_warm_s": prove_warm_s,
          "prove_warm_stage_s": stage_s(warm_stages), "warm_proof_equal": True,
          "peak_bytes": peak,
          "setup_launches": setup_launches, "launches": launches,
          "launches_by_n": by_n, "graph_launches": replayed,
          "launches_note": "setup + first proof, launches that ran: issued "
                           "from Python plus replayed (graph_launches: the "
                           "replays alone)",
          "prewarmed_graphs_replays": prewarm_replays, "ok": True, "tampered_ok": False,
          "bytes_api_ok": True, "phases_before": list(order), **info})
    helper = phase_epoch_helper([t.block for t in transitions])
    graph_lines("epoch_snark")
    drop_graphs("epoch_snark")
    return launches, helper


def phase_epoch_helper(blocks, seed=b"e2e-hash-helper0"):
    """The 2-SNARK helper proof over BLS12-377 on the card: setup of
    HashToBits over the epoch blocks and generate_hash_helper, verified
    against the public inputs the helper statement fixes."""
    profiling.reset()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    hcs = ConstraintSystem(g16.BLS12_377_ENGINE.fr, "setup")
    HashToBits.empty(len(blocks)).generate_constraints(hcs)
    helper_pk = g16.generate_parameters(hcs, g16.BLS12_377_ENGINE, XorShiftRng(seed),
                                        accel=get_accel("bls12_377", DEV))
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    helper = api.generate_hash_helper(helper_pk, blocks, device="cuda")
    prove_s = time.perf_counter() - t0
    launches = run_launches()
    by_n = launch_counts_by_n()
    if not by_n["mont_mul"].get(17) or not by_n["mont_mul"].get(25):
        fail(f"epoch_snark helper: mont_mul<17> and mont_mul<25> must both launch: {by_n}")
    require_path_kernels("epoch_snark helper", launches)
    msg_bits = api.xof_input_message_bits(blocks)
    xof_bits = []
    for bits in msg_bits:
        out = DirectHasher().xof(SIG_DOMAIN, bits_le_to_bytes_le(bits), 64)
        xof_bits += bytes_le_to_bits_le(out, 512)
    inputs = HashToBits.public_inputs(msg_bits, xof_bits)
    engine = g16.BLS12_377_ENGINE
    if not g16.verify_proof(helper_pk.vk, helper.proof, inputs, engine):
        fail("epoch_snark helper: the helper proof does not verify")
    if g16.verify_proof(helper_pk.vk, helper.proof, [inputs[0] + 1] + inputs[1:], engine):
        fail("epoch_snark helper: the helper proof verifies a changed input")
    line({"phase": "epoch_snark_helper", "engine": "bls12_377",
          "epochs": len(blocks), "constraints": hcs.num_constraints,
          "domain": len(helper_pk.h_query) + 1, "instance": len(inputs),
          "setup_s": setup_s, "prove_s": prove_s,
          "stage_s": {k: v["total_s"] for k, v in profiling.report().items()},
          "peak_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "launches_by_n": by_n,
          "graph_launches": aotcache.graph_launches(), "ok": True,
          "changed_input_ok": False})
    return launches


def phase_shape_sweep():
    """The launch-shape sweep through its script's entry point, with the
    counts set to 0 just before and read just after."""
    reset_counts()
    rows = prof_field.sweep(B=SHAPE_B)
    launches = run_launches()
    if not all(r["equal"] for r in rows):
        fail("shape sweep: a block size's chain differs from mont_mul's")
    stray = {r["kernel"]: r for r in rows
             if r.get("spill_stores") or r.get("spill_loads") or "registers" not in r}
    if stray:
        fail(f"shape sweep: a shape spills or has no ptxas report: {stray}")
    if launches["mont_mul_shape"] <= 0:
        fail("shape sweep: mont_mul_shape was not launched")
    line({"phase": "shape_sweep", "B": SHAPE_B, "rows": rows, "launches": launches})
    return launches


def add_launches(total, part):
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def msm_profile(accel, bases, ss):
    """One MSM under utils/profiling.py's device_trace: the summed time of
    all kernels on the card against the wall time of its device stage."""
    profiling.reset()
    torch.cuda.synchronize()
    with profiling.device_trace() as prof:
        accel.g1.msm(bases, ss)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    wall = sum(v["total_s"] for k, v in profiling.report().items()
               if k in ("msm.pack_bases", "msm.device"))
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    return {"phase": "prover_msm_profile", "replayed_graphs": True,
            "pack_and_device_wall_s": wall,
            "device_busy_s": busy if busy else "not measured",
            "device_busy_share": busy / wall if busy else "not measured",
            "kernel_launches": sum(e.count for e in kern),
            "top_kernels": [{"name": e.key[:60], "count": e.count,
                             "device_s": e.self_device_time_total / 1e6} for e in top],
            "note": "profiled run; the profiler adds host time per launch"}


def phase_prover(lg_msm=20, lg_ntt=20, seed=20261016):
    """The prover's device stages through DeviceAccel("bw6_761"), first
    with mont_mul, then the MSM and the h-polynomial again with every
    multiply through mont_mul_tc. Returns the launches of each run."""
    engine = BW6_761_ENGINE
    accel = DeviceAccel("bw6_761", DEV)
    B, d = 1 << lg_msm, 1 << lg_ntt
    ss = prover.msm_scalars(engine, B, seed + 1)
    evals = prover.h_inputs(engine, d, seed + 2)
    vals = prover.ntt_values(dntt.ntt_fr, d, seed + 4)
    cios = {}
    with F.mul_kernel("cios"):
        ks, bases, res = prover.fixed_base_stage(accel, engine, B, seed)
        results = [res]
        point, res = prover.msm_stage(accel, engine, bases, ks, seed + 1, ss)
        results.append(res)
        h, res = prover.h_stage(accel, engine, d, seed + 2, evals=evals)
        results.append(res)
        h_stage_s = res["stage_s"]
        results.append(prover.h_dense(accel, engine, 1 << 12, seed + 3))
        results.append(prover.ntt_stage(dntt.ntt_fr, d, seed + 4, DEV, vals))
        for res in results:
            line({"phase": "prover", "mul": "cios", **res})
            if not res["ok"]:
                fail(f"prover path: stage {res['stage']} disagrees with its host oracle")
            add_launches(cios, res.get("launches", {}))
            add_launches(cios, res.get("graph_launches", {}))
        if cios["mont_mul"] <= 0 or cios["mont_redc"] <= 0 or cios["mont_mul_tc"]:
            fail(f"prover path: unexpected launch counts {cios}")
        graph_lines("prover cios")
    tc = {}
    with F.mul_kernel("tc"):
        point_tc, res = prover.msm_stage(accel, engine, bases, ks, seed + 1, ss)
        h_tc, res_h = prover.h_stage(accel, engine, d, seed + 2, points=0, evals=evals)
        for res in (res, res_h):
            line({"phase": "prover", "mul": "tc", **res})
            add_launches(tc, res["launches"])
            add_launches(tc, res["graph_launches"])
        if not res["ok"] or point_tc != point:
            fail("prover path (tc): the MSM result differs")
        if not (h_tc.limbs == h.limbs).all():
            fail("prover path (tc): the h-polynomial's limbs differ")
        if tc["mont_mul_tc"] <= 0 or tc["mont_mul"] != 0:
            fail(f"prover path (tc): not every multiply went through mont_mul_tc: {tc}")
        graph_lines("prover tc")
    # the profiled MSM comes last: it is there for the card's busy share
    # alone, and both multiplies' stages are timed before a profiler has
    # traced an MSM
    with F.mul_kernel("cios"):
        rnd = random.Random(seed + 5)
        line(msm_profile(accel, bases, [rnd.randrange(engine.fr) for _ in range(B)]))
    drop_graphs("prover")
    line({"phase": "prover_path", "msm_points": B, "h_domain": d,
          "launches_cios": cios, "launches_tc": tc,
          "msm_equal_host": True, "tc_equal_cios": True})
    state = {"bases": bases, "scalars": ss, "point": point, "evals": evals,
             "h": h, "h_stage_s": h_stage_s, "d": d, "ntt_fr_values": vals}
    return cios, tc, state


def card_s(fn):
    """fn() and its seconds between two synchronizations of the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def raw_limbs(nttops, x):
    """Canonical raw limbs of a Montgomery batch, on the host."""
    return nttops.f.to_raw(x).cpu().numpy()


def mesh_pairings(mesh, main_inputs):
    """The sharded signature sum and pairing check on the entry inputs (8
    messages: 9 pairs) and on 1,024 pairs from the verification path's
    inputs (1,023 signatures, hashes and the committee key), each honest
    and with its first signature tampered."""
    out = {}
    negg2 = bench.dbls.neg_g2_gen_affine(DEV)
    sig8, hashes8, apk8 = port_entry.example_inputs(device=DEV)
    sigs, hashes, apk = main_inputs
    k = min(1023, sigs[0].shape[-1])
    sig1k = bench.dbls.cat_lanes(tree_map(lambda x: x[:, :k], sigs), dc.g1_pack([None], DEV))
    hashes1k = dc.g1.to_affine(tree_map(lambda x: x[:, :k], hashes))
    apk1k = tree_map(lambda x: x.expand(x.shape[0], k), apk)
    for name, sig, h_aff, apk_aff in (("entry_9_pairs", sig8, hashes8, apk8),
                                      ("batch_1024_pairs", sig1k, hashes1k, apk1k)):
        for tampered in (False, True):
            s = double_lane(sig) if tampered else sig
            asig = dc.g1.to_affine(pmesh.sharded_msum_g1(mesh, s))
            p = bench.dbls.cat_lanes(asig, h_aff)
            q = bench.dbls.cat_lanes(negg2, apk_aff)
            out[name + ("_tampered" if tampered else "")] = bool(
                pmesh.sharded_pairing_check(mesh, p, q)[0])
    return out


def set_mesh_check(mesh, seed):
    """A size-1 set_mesh keeps DeviceAccel on the single-card route: the
    h-polynomial at 2^12 and an MSM of 4,096 points give the same results
    and the same launches (per kernel and limb count issued from Python,
    and replayed from the same graphs) with and without it. A first run
    captures the graphs, so that the compared runs are alike."""
    accel = DeviceAccel("bls12_377", DEV)
    rnd = random.Random(seed)
    d = 1 << 12
    evals = [[rnd.randrange(R) for _ in range(d)] for _ in range(3)]
    pts = port_entry.chain_points(hc.G1, G1_GENERATOR, 3, d)
    sc = [rnd.randrange(R) for _ in pts]
    runs = []
    try:
        for m in (None, None, mesh, None):
            accel.set_mesh(m)
            reset_counts()
            h = accel.compute_h_evals(*evals, d, g16.BLS12_377_ENGINE.fr_generator)
            pt = accel.g1.msm(pts, sc)
            runs.append(((launch_counts_by_n(), aotcache.graph_launches()), h.limbs, pt))
        runs = runs[1:]
    finally:
        accel.set_mesh(None)
    same = all(r[0] == runs[0][0] and (r[1] == runs[0][1]).all() and r[2] == runs[0][2]
               for r in runs)
    return same, runs[1][0]


# the tags of the mesh path's programs (parallel/mesh.py::_program), each
# called until it replays
MESH_PROGRAMS = ("mesh_compute_h_", "mesh_ntt_fr253_0", "mesh_ntt_fr253_1",
                 "mesh_ntt_fq377_0", "mesh_ntt_fq377_1", "mesh_pip_bw6_g1",
                 "mesh_msum_g1", "mesh_pairing_check")


def phase_mesh(state, main_inputs, seed=20261020):
    """The mesh (parallel/) at world size 1 on a real NCCL group, at the
    prover's width on the prover phase's own inputs and results. With the
    counts set to 0 just before and read just after: sharded_compute_h at
    d = 2^20 over BW6-Fr, the four-step NTT round trip at 2^20 over both
    scalar fields, the sharded Pippenger MSM over the prover's 2^20 BW6-761
    bases, the sharded sum and pairing checks, entry.dryrun_multichip.
    Then the checks: the h limbs equal compute_h_evals', the NTTs the
    radix-2 NTT's (timed beside them) and the host's Horner values, the
    MSM point the single card's; and a size-1 set_mesh leaves the
    accelerator's launches unchanged. Returns the launches of the run."""
    import tempfile

    d, evals = state["d"], state["evals"]
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pdist.init_distributed(f"file://{tmp}/store", 1, 0, device=DEV)
        try:
            mesh = pdist.global_mesh()
            backend = torch.distributed.get_backend()
            want = "nccl" if DEV.type == "cuda" else "gloo"
            if (mesh.size, mesh.rank, mesh.device, backend) != (1, 0, DEV, want):
                fail(f"mesh: expected one {want} rank on {DEV}, got {mesh} on {backend}")
            secs["init_distributed"] = time.perf_counter() - t0
            raws = [F.FQ.pack_raw(e, DEV) for e in evals]
            vals_fr = state["ntt_fr_values"]
            inputs = {"fr253": (dntt.ntt_fr, F.FR.pack_raw(vals_fr, DEV), vals_fr),
                      "fq377": (dntt.ntt_bw6, raws[0], evals[0])}
            xs = {k: ops.f.from_raw(raw) for k, (ops, raw, _) in inputs.items()}
            torch.cuda.synchronize()
            # the mesh path, counts set to 0 just before and read just after:
            # each function called until its programs replay (the first call
            # of a key runs eagerly, the second captures and replays, the
            # third replays), every call's result the same
            reset_counts()
            calls = ("eager", "capture", "replay")
            h_runs = []
            for call in calls:
                h_raw, secs[f"sharded_compute_h_{call}"] = card_s(
                    lambda: pmesh.sharded_compute_h(mesh, dntt.ntt_bw6, *raws, d,
                                                    BW6_761_ENGINE.fr_generator))
                h_runs.append(h_raw)
            fwd_runs, back_runs = {}, {}
            for k, (ops, _, _) in inputs.items():
                fwd_runs[k], back_runs[k] = [], []
                for call in calls:
                    f_k, secs[f"four_step_ntt_{k}_{call}"] = card_s(
                        lambda: pmesh.sharded_ntt(mesh, xs[k], ops))
                    b_k, secs[f"four_step_intt_{k}_{call}"] = card_s(
                        lambda: pmesh.sharded_ntt(mesh, f_k, ops, inverse=True))
                    fwd_runs[k].append(f_k)
                    back_runs[k].append(b_k)
            pip_runs = []
            for call in calls:
                pt, secs[f"sharded_msm_pippenger_{call}"] = card_s(
                    lambda: pmesh.sharded_msm_pippenger(
                        mesh, state["bases"], state["scalars"], curve=dc.bw6_g1, nbits=377))
                pip_runs.append(pt)
            # each pass checks two shapes honest and tampered: the first pass
            # runs each key eagerly, then captures it; the second replays
            pair_runs = []
            for call in ("eager_and_capture", "replay"):
                v, secs[f"pairing_checks_{call}"] = card_s(
                    lambda: mesh_pairings(mesh, main_inputs))
                pair_runs.append(v)
            _, secs["dryrun_multichip"] = card_s(lambda: port_entry.dryrun_multichip(mesh))
            launches, by_n = run_launches(), launch_counts_by_n()
            require_path_kernels("mesh", launches)
            mesh_graphs = {f"{e.jit.tag} {aotcache.key_str(e.key)}": e.replays
                           for e in aotcache.entries() if e.jit.tag.startswith("mesh_")}
            # a CPU rehearsal (gloo) runs the bodies: graphs only on the card
            for prefix in MESH_PROGRAMS if DEV.type == "cuda" else ():
                if not any(k.startswith(prefix) and n for k, n in mesh_graphs.items()):
                    fail(f"mesh: no replayed graph of {prefix}* on {backend}: {mesh_graphs}")
            if not (all((h == h_runs[0]).all() for h in h_runs)
                    and all(same_leaves(x, r[0]) for r in (*fwd_runs.values(),
                                                           *back_runs.values()) for x in r)
                    and all(p == pip_runs[0] for p in pip_runs)
                    and all(v == pair_runs[0] for v in pair_runs)):
                fail("mesh: a replayed graph's result differs from the eager run's")
            h_raw, point, verdicts = h_runs[0], pip_runs[0], pair_runs[0]
            fwd = {k: r[0] for k, r in fwd_runs.items()}
            back = {k: r[0] for k, r in back_runs.items()}
            same_route, route_launches = set_mesh_check(mesh, seed)
            # every program of the phase checked while its communicator is up
            graph_lines("mesh")
            drop_graphs("mesh")
        finally:
            pdist.shutdown()
    if not (h_raw.astype(np.uint16)[:, : d - 1] == state["h"].limbs).all():
        fail("mesh: sharded_compute_h differs from compute_h_evals at 2^20")
    ntt_rows = {}
    for k, (ops, raw, vals) in inputs.items():
        ref, t_radix2 = card_s(lambda: ops.ntt(xs[k]))
        if not (raw_limbs(ops, fwd[k]) == raw_limbs(ops, ref)).all():
            fail(f"mesh: the four-step NTT over {k} differs from the radix-2 NTT")
        if not (raw_limbs(ops, back[k]) == raw.cpu().numpy()).all():
            fail(f"mesh: the four-step NTT round trip over {k} lost its input")
        w = ops.root_fn(d)
        for j in (1, d // 2 + 3):
            if ops.spec.unpack(fwd[k][:, j:j + 1])[0] != prover.horner(vals, pow(w, j, ops.r), ops.r):
                fail(f"mesh: the four-step NTT over {k} differs from the host at lane {j}")
        ntt_rows[k] = {"four_step_s": {c: secs[f"four_step_ntt_{k}_{c}"] for c in calls},
                       "radix2_s": t_radix2,
                       "four_step_inverse_s": {c: secs[f"four_step_intt_{k}_{c}"]
                                               for c in calls}}
    if point != state["point"]:
        fail("mesh: the sharded Pippenger MSM differs from the single card's")
    want = {"entry_9_pairs": True, "entry_9_pairs_tampered": False,
            "batch_1024_pairs": True, "batch_1024_pairs_tampered": False}
    if verdicts != want:
        fail(f"mesh: pairing verdicts {verdicts}, expected {want}")
    if not same_route:
        fail("mesh: a size-1 set_mesh changed the accelerator's route")
    line({"phase": "mesh", "world_size": 1, "backend": backend, "device": str(DEV),
          "d": d, "seconds": secs, "ntt_by_field": ntt_rows,
          "h_poly_single_card_s": state["h_stage_s"],
          "launches": launches, "launches_by_n": by_n,
          "h_equal_compute_h_evals": True, "ntt_equal_radix2_and_host": True,
          "msm_equal_single_card": True, "verdicts": verdicts,
          "dryrun_multichip": True, "size1_set_mesh_launches": route_launches,
          "size1_set_mesh_same_route": True, "graphs_replays": mesh_graphs,
          "replays_equal_eager": True})
    return launches


def main():
    record_calls()
    smi = phase_device()
    rows, worst = phase_kernels()
    rows["f12_cyclo_sq"], worst["f12_cyclo_sq"] = phase_cyclo_sq()
    rows["f12_mul"], worst["f12_mul"] = phase_f12_mul()
    phase_entry()
    by_path = {}
    by_path["verify"], main_inputs = phase_main()
    by_path["shape_sweep"] = phase_shape_sweep()
    by_path["prover_cios"], by_path["prover_tc"], prover_state = phase_prover()
    by_path["mesh"] = phase_mesh(prover_state, main_inputs)
    del prover_state, main_inputs
    by_path["hash_verify"] = phase_hash_verify()
    by_path["strict_verify"], block_hashes = phase_strict_verify()
    by_path["strategies"] = phase_strategies(block_hashes, smi)
    by_path["epoch"], by_path["epoch_helper"] = phase_epoch_snark(order=list(by_path))
    out = []
    for name, per_width in rows.items():
        if name == "mont_mul_shape":
            main_row = next(r for r in per_width
                            if (r["B"], r["threads"]) == (SHAPE_B, 128))
        else:
            main_row = next(r for r in per_width
                            if (r["n"], r["B"]) == MAIN_WIDTH[name])
        out.append({
            "name": name, "route": "cuda",
            **KERNEL_INFO[name],
            "launches": sum(p[name] for p in by_path.values()),
            "launches_by_path": {k: p[name] for k, p in by_path.items()},
            "launches_note": "launches that ran on each path: issued from "
                             "Python plus replayed from CUDA graphs; a "
                             "capture records launches and counts none",
            "max_abs_err": worst[name],
            "ms": main_row["ms"], "eager_ms": main_row["eager_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None, "library_note": NO_LIBRARY,
            "n": main_row["n"], "B": main_row["B"], "widths": per_width,
            "card": smi,
        })
    line({"kernels": out})
    print(f"chip_smoke: all phases passed in {time.perf_counter() - T_START:.1f} s",
          flush=True)
    line({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
