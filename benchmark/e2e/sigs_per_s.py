"""Signatures whose verdict the window returned, a second: every completed
call's signatures (an aggregate block seal counts one) over the window's
seconds, from its first call's start to its last call's end."""


def read(run):
    return len(run["calls"]) * run["sigs_per_call"] / run["window_s"]
