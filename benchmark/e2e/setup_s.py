"""Seconds from the start of the process to the first timed call: library
load, the inputs made from the seed, the reference hashes where the
checkout has not cached them, every program's eager call and capture."""


def read(run):
    return run["setup_s"]
