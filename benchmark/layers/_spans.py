"""Per-call means of named spans, shared by the span readers."""


def mean_ms(run, names):
    """Mean over the window's calls of the summed seconds of `names`, in
    ms; None where no call recorded any of them."""
    vals = [sum(c["spans"].get(n, 0.0) for n in names) for c in run["calls"]]
    if not any(any(n in c["spans"] for n in names) for c in run["calls"]):
        return None
    return 1e3 * sum(vals) / len(vals)
