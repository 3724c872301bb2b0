"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, and the build of csrc/field.cu with nvcc for sm_90a;
  2. kernels: mont_mul (n = 17, 25, 49) and mont_redc (n = 17, 25, 49)
     against their plain PyTorch versions on the card, exactly, on random
     lazy inputs in (-200p, 200p) with signed limbs, at B in {1, 127, 128,
     4099, 2^20}; then, again exactly against the plain version, each
     kernel's time, bound and plain-version time at the widths the main
     path launches (2, 12, 108, 12288 and 2^20 lanes at n = 25), printed
     as one `kernels` line
     (`ms` is the card's time per launch, from a replayed CUDA graph of the
     launches; `eager_ms` the time per call issued from Python);
  3. entry(): the 8-message, 4-validator verification is True on the
     card, a tampered batch is False, and the card's final-exponentiation
     output equals the CPU run's limb for limb;
  4. the main path at the benchmark's defaults (524,288 messages, 100
     validators, one group, the benchmark's seed): with the launch counts
     set to 0 just before and read just after, the warm-up verification is
     True; a stage-by-stage run of the same pipeline gives each stage's
     time and launches, and its affine P legs equal the host's; a tampered
     batch is False; the benchmark's 5 timed verifications give the metric
     line; one profiled verification gives
     the card's busy time;
  5. the last line: {"ok": true, "device": {...}}.

It imports nothing of the JAX package, and exits non-zero without
printing a result when no card is available.
"""

import json
import subprocess
import sys
import time

import torch


def line(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


if not torch.cuda.is_available():
    fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")

from celo_bls_snark_tpu_torch import bench  # noqa: E402
from celo_bls_snark_tpu_torch import entry as port_entry  # noqa: E402
from celo_bls_snark_tpu_torch.convert import tree_to_numpy  # noqa: E402
from celo_bls_snark_tpu_torch.hostmath import curves as hc  # noqa: E402
from celo_bls_snark_tpu_torch.ops import curve as dc  # noqa: E402
from celo_bls_snark_tpu_torch.ops import field as F  # noqa: E402
from celo_bls_snark_tpu_torch.ops import kernels  # noqa: E402
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
KERNEL_INFO = {
    "mont_mul": {
        "source": "celo_bls_snark_tpu_torch/csrc/field.cu",
        "replaces": "celo_bls_snark_tpu/ops/field.py:252",
    },
    "mont_redc": {
        "source": "celo_bls_snark_tpu_torch/csrc/field.cu",
        "replaces": "celo_bls_snark_tpu/ops/field.py:479",
    },
}
NO_LIBRARY = ("no PyTorch call computes a multi-precision Montgomery "
              "product or reduction")


def bound(name, n, B):
    """(bound_ms, bound_by) for one launch over B lanes: the larger of
    bytes / HBM rate (inputs read once, output written once) and the
    32-bit integer operations of a 16-bit-radix CIOS / the FP32
    lane-instruction rate (a ceiling on the integer rate). Per lane, mont_mul needs 2 n^2 multiplies (a_i b_j and m_i p_j)
    and about 4 n^2 adds, shifts and masks to accumulate their halves
    (6 n^2); mont_redc needs half of that (3 n^2)."""
    if name == "mont_mul":
        nbytes, ops = 12 * n * B, 6 * n * n * B
    else:
        nbytes, ops = 8 * n * B, 3 * n * n * B
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / LANE_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def lazy_batch(spec, B, gen):
    """Random lazy [n, B] int32 limbs on the card: a value v0 < 2^(16(n-2))
    < p plus s p with s in [-199, 199], its limbs then re-split with random
    signed carries (value kept); lanes 0..2 hold 0, 1 and p-1 when B > 3."""
    n = spec.n
    lo = torch.randint(0, 1 << 16, (n, B), generator=gen, device=DEV)
    lo[n - 2:] = 0
    s = torch.randint(-199, 200, (1, B), generator=gen, device=DEV)
    limbs = lo + s * spec.column(spec.p_limbs, DEV, torch.int64)
    d = torch.randint(-512, 512, (n - 1, B), generator=gen, device=DEV)
    limbs[:-1] += d << 16
    limbs[1:] -= d
    if B > 3:
        limbs[:, 0] = 0
        limbs[:, 1] = torch.as_tensor(F.int_to_limbs(1, n), device=DEV)
        limbs[:, 2] = torch.as_tensor(F.int_to_limbs(spec.modulus - 1, n), device=DEV)
    assert int(limbs.abs().max()) < (1 << 26)
    return limbs.to(torch.int32).contiguous()


def check_model(spec, a, b, out, lanes=16):
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


def time_ms(fn, iters, graph=False):
    """Mean milliseconds per call of fn between CUDA events. Eager, a call
    costs what the host spends issuing it whenever that exceeds the card's
    time; with graph=True the calls are captured once into a CUDA graph and
    replayed, so the events time the card's work alone."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        t0.record()
        g.replay()
        t1.record()
    else:
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip(), flush=True)
    info = kernels.build()
    regs = [l.strip() for l in info["ptxas"].splitlines()
            if any(w in l for w in ("entry function", "registers", "spill"))]
    line({"phase": "device", "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "build_s": info["seconds"], "built": info["built"],
          "library": info["path"], "ptxas_registers": regs})
    return smi.stdout.strip()


def phase_kernels():
    gen = torch.Generator(device=DEV)
    gen.manual_seed(20261016)
    max_err = {"mont_mul": 0, "mont_redc": 0}
    checked = 0
    for n, spec in SPECS.items():
        for B in WIDTHS:
            a, b = lazy_batch(spec, B, gen), lazy_batch(spec, B, gen)
            got = F.mont_mul(spec, a, b)
            want = F._mul_plain(spec, a, b)
            err = int((got.long() - want.long()).abs().max())
            max_err["mont_mul"] = max(max_err["mont_mul"], err)
            if err:
                fail(f"mont_mul n={n} B={B}: max |kernel - plain| = {err}")
            got_r = F.mont_redc(spec, a)
            want_r = F._redc_plain(spec, a)
            err = int((got_r.long() - want_r.long()).abs().max())
            max_err["mont_redc"] = max(max_err["mont_redc"], err)
            if err:
                fail(f"mont_redc n={n} B={B}: max |kernel - plain| = {err}")
            if B == 127:
                check_model(spec, a, b, got)
                check_model(spec, a, None, got_r)
            checked += 1
    torch.cuda.synchronize()
    line({"phase": "kernels_exact", "cases": checked, "max_abs_err": max_err,
          "widths": WIDTHS, "limbs": list(SPECS)})
    # timing at the widths the main path launches (FQ, n = 25): the fold's
    # complete adds (6 x 2048 lanes), to_affine's inversion and the Miller
    # loop's infinity tests (2 lanes), the pairing's Fq12 products at batch
    # 2 (54 x 2), the zero tests of f12_is_one (12 x 1), and 2^20 lanes
    spec = F.FQ
    shapes = {"mont_mul": [2, 108, 12288, 1 << 20],
              "mont_redc": [2, 12, 1 << 20]}
    main_width = {"mont_mul": 12288, "mont_redc": 2}
    rows = {}
    for name, widths in shapes.items():
        kern = F.mont_mul if name == "mont_mul" else F.mont_redc
        plain = F._mul_plain if name == "mont_mul" else F._redc_plain
        per_width = []
        for B in widths:
            a, b = lazy_batch(spec, B, gen), lazy_batch(spec, B, gen)
            args = (a, b) if name == "mont_mul" else (a,)
            err = int((kern(spec, *args).long()
                       - plain(spec, *args).long()).abs().max())
            max_err[name] = max(max_err[name], err)
            if err:
                fail(f"{name} n=25 B={B}: max |kernel - plain| = {err}")
            iters = 200 if B < 100000 else 20
            ms = time_ms(lambda: kern(spec, *args), iters, graph=True)
            eager_ms = time_ms(lambda: kern(spec, *args), iters)
            plain_ms = time_ms(lambda: plain(spec, *args), 3 if B > 100000 else 20)
            bms, by = bound(name, spec.n, B)
            per_width.append({"B": B, "max_abs_err": err, "ms": ms, "eager_ms": eager_ms,
                              "plain_ms": plain_ms, "bound_ms": bms,
                              "bound_by": by})
        rows[name] = per_width
    return rows, main_width, max_err


def tamper_first_lane(pt):
    """Replace lane 0 of a G1 projective batch by its double: still a
    subgroup point, but no longer the signature of that message."""
    first = tree_map(lambda x: x[:, :1], pt)
    doubled = dc.g1.double(first)
    return tree_map(lambda d, x: torch.cat([d, x[:, 1:]], dim=-1), doubled, pt)


def phase_entry():
    fn, args = port_entry.entry(device="cuda")
    st = port_entry.verify_stages(*args)
    if not bool(st["ok"][0]):
        fail("entry(): verification on the card returned False")
    bad = (tamper_first_lane(args[0]),) + tuple(args[1:])
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
        times[name] = {"s": time.perf_counter() - t0,
                       **{k.name: k.launches for k in F.KERNELS}}
        return out

    st = bench.dbls.batch_verify_grouped_stages(sigs, hashes, apk, 1, stage=stage)
    if not bool(st["ok"][0]):
        fail("main path: the stage-by-stage verification returned False")
    return times, st


def device_profile(sigs, hashes, apk):
    """One verification under torch.profiler: wall time, the summed time
    of all kernels on the card, its share of the wall time, kernel count,
    and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bench.verify(sigs, hashes, apk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    ours = [e for e in kern if "mont_" in e.key]
    return {
        "port_kernels": [{"name": e.key[:60], "count": e.count,
                          "device_s": e.self_device_time_total / 1e6} for e in ours],
        "wall_s": wall,
        "device_busy_s": busy_us / 1e6 if busy_us else "not measured",
        "device_busy_share": busy_us / 1e6 / wall if busy_us else "not measured",
        "kernel_launches": sum(e.count for e in kern),
        "top_kernels": [{"name": e.key[:60], "count": e.count,
                         "device_s": e.self_device_time_total / 1e6} for e in top],
        "note": "profiled run; the profiler adds host time per launch",
    }


def phase_main(n_messages=524288, n_validators=100, n_iter=5,
               n_seed=bench.N_SEED):
    t0 = time.perf_counter()
    sigs, hashes, apk = bench.build_inputs(n_messages, n_validators,
                                           device=DEV, n_seed=n_seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the main path through the benchmark's entry point, with the launch
    # counts set to 0 just before and read just after exactly this run
    F.reset_launches()
    t0 = time.perf_counter()
    bench.warm_up(sigs, hashes, apk)
    warm_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in F.KERNELS}
    for name, count in launches.items():
        if count <= 0:
            fail(f"main path: kernel {name} was not launched")
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
    if bool(bench.verify(tamper_first_lane(sigs), hashes, apk)[0]):
        fail("main path: tampered batch verified True")
    metric = bench.timed(n_messages, sigs, hashes, apk, n_iter=n_iter)
    line({"phase": "main_path_stages", **stages})
    line({"phase": "main_path_profile", **device_profile(sigs, hashes, apk)})
    line({"phase": "main_path", "messages": n_messages,
          "validators": n_validators, "groups": 1, "input_build_s": build_s,
          "warmup_s": warm_s, "launches_per_verify": launches,
          "p_aff_equal_host": True, "tampered_ok": False})
    line(metric)
    return launches


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    rows, main_width, max_err = phase_kernels()
    phase_entry()
    launches = phase_main()
    out = []
    for name, per_width in rows.items():
        main = next(r for r in per_width if r["B"] == main_width[name])
        out.append({
            "name": name, "route": "cuda",
            **KERNEL_INFO[name],
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": main["ms"], "eager_ms": main["eager_ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "library_note": NO_LIBRARY,
            "n": 25, "B": main["B"], "widths": per_width,
            "card": smi,
        })
    line({"kernels": out})
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    line({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
