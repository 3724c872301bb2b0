"""ms a call that the host spends launching the program's graphs: the
program's host stage aot.launch (utils/aotcache.py) around each
CUDAGraph.replay(), the cudaGraphLaunch alone, summed over a call's
replays."""

from benchmark.layers import _spans


def read(run):
    return _spans.mean_ms(run, ["aot.launch"])
