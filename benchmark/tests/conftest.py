"""Shared pieces of the benchmark's CPU tests: the cells shrunk to a size
the CPU's plain path runs in seconds a call."""

TINY = {
    "sync100.prehashed": {"params": {"messages_per_call": 16, "committees": 2, "seals": 4,
                                     "sets": 6}},
    "batch300x20.strict": {"config": {"blocks": 4, "validators_per_block": 2}},
    "batch300x20.individual": {"config": {"blocks": 4, "validators_per_block": 2}},
}
