"""mont_mul's share of its roofline over the profiled calls, in %: the
least time its launches could take (benchmark/peaks.py: bytes at the HBM
rate or 32-bit multiplies at the lane rate, the larger) over the time they
took, summed over every launch of csrc/field.cu's mont_mul_kernel<n, ...>.
n comes from the kernel's template, the lanes from grid x block, which
round the launch's lanes up to a whole block (at most 127 lanes more)."""

import re

from benchmark import peaks

_NAME = re.compile(r"\bmont_mul_kernel<(\d+)")


def _prod(v):
    out = 1
    for x in v:
        out *= int(x)
    return out


def read(run):
    prof = run.get("profile")
    if not prof:
        return None
    bound = took = 0.0
    for e in prof["events"]:
        m = _NAME.search(e["name"]) if e["on_device"] else None
        if m is None or "grid" not in e:
            continue
        bound += peaks.mont_mul_bound_s(int(m.group(1)), _prod(e["grid"]) * _prod(e["block"]))
        took += e["end"] - e["start"]
    return 100.0 * bound / took if took > 0 else None
