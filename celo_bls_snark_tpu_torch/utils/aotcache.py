"""Per-shape CUDA-graph program cache (the counterpart of the JAX package's
utils/aotcache.py).

The JAX package runs each of its device programs as one compiled executable
per argument shape, and keeps the executables on disk so that a later
process loads them instead of compiling. The port keeps the executable half
and drops the disk half: `AotJit(tag, fn)` captures `fn` into a CUDA graph
for a key it has seen before and replays that graph on every later call with
the key. The port caches captured CUDA graphs in the process, not
executables on disk: a CUDA graph cannot be serialized, and what does cross
processes (the kernel library) is cached by ops/kernels.py's nvcc build.

Key: the tree structure of the arguments and the shape, dtype and device of
every tensor leaf (the JAX _arg_key), plus the field multiply that
ops/field.py::mul_kernel selects, which a graph bakes in. The static
arguments (groups, c, L, N, Lc, cap, the domain, compat) are closed over by
`fn` and named in `tag`, as in the JAX tags: a caller keeps one AotJit per
static key, and `jit(tag, fn, *owners)` keeps one per (tag, owners).

Calls on a CUDA key, on the caller's thread and device:
  1. the first runs fn eagerly and returns its result: that fills the
     per-device constant caches (FieldSpec.column, the NTT and
     Tonelli-Shanks tables, ...), builds and loads the kernels and warms
     the allocator, none of which may happen inside a capture, and a
     program called once per shape (a setup's fixed-base batch, a single
     proof) costs what it costs eagerly;
  2. the second copies the inputs into static buffers, captures fn into a
     torch.cuda.CUDAGraph, in the memory pool that every graph of the
     device shares, and writes one line to stderr,
       [aot] MISS <tag> <key> captured in X s, N kernels, pool +P bytes
     N counts the graph's kernel nodes (PyTorch's and the port's), P the
     bytes the shared pool grew by in the capture;
  3. the second and every later call copies the inputs into the static
     buffers, replays the graph and returns clones of the outputs: JAX
     returns fresh arrays, and a graph's outputs are overwritten by its next
     replay.
`prepare(*args)` does 1 and 2 without a replay (DeviceAccel.prewarm_prove).

A process-wide lock serializes the calls, as the JAX per-instance lock
serializes its compiles. Captures run in capture_error_mode="thread_local",
so an allocation, a copy or a kernel of another thread does not break them;
a device-wide synchronize from another thread does.

One pool for all graphs of a device: a graph's intermediates are dead
between its replays, its inputs are static buffers outside the pool, and its
outputs are cloned under the lock right after its replay, so no graph reads
memory that another's replay writes, in any order of replays. The pool then
holds the largest graph's working set and every graph's outputs, where a
pool per graph would hold every working set. A shared pool frees its memory
only when its last graph goes, so the cache is bounded as a whole: before a
capture, a pool past POOL_SHARE of the card's memory is dropped with every
graph in it ([aot] DROP on stderr), and the graphs still in use are captured
again at their next call.

Launch counters: the kernels' counters (ops/field.py KERNELS) count the
launches that ran from Python; a capture's calls of the wrappers only record
kernels, so a capture takes its counts back out. The launches of a graph
(`Entry.info["port_kernels"]`) are added up per replay in graph_launches().

Spans (utils/profiling.py): a capture runs fn inside the device span
`gpu.graph`, so every graph records its own start and end events, and keeps
the device spans that fn opened inside it (`Entry.pairs`, their names in
`Entry.info["spans"]`; event-record nodes, not kernel nodes). A replay is
the host stage `aot.launch` around CUDAGraph.replay() alone (the
cudaGraphLaunch; a profiler's range is named `aot.launch:<tag>`); after it
the graph's pairs are armed for profiling.report(). Pairs a previous replay
left unread are read first, or dropped (`gpu.dropped`) where the card has
not reached them: a loop that replays without a host read between replays
loses samples and is never slowed.

CPU tensors call fn directly, as the JAX AotJit passes straight to jit on
the CPU backend; that happens only when the caller passes CPU tensors.
There is no fallback: a capture or replay that fails raises with the tag and
the key, and never runs fn eagerly in the graph's place.
"""

import ctypes
import sys
import threading
import time
import weakref

import torch

from . import profiling
from .tree import tree_leaves, tree_map

POOL_SHARE = 0.25  # of the card's memory, the most a device's pool keeps

_LOCK = threading.RLock()
_ALL = []  # weak references to every AotJit, in construction order
_BY_TAG = {}  # (tag, ids of its owners) -> the AotJit that jit() made
_POOLS = {}  # device -> the _Pool its graphs share
_REPLAYED = {}  # kernel name -> launches that replays ran since reset_replays()

_CU_GRAPH_NODE_TYPE_KERNEL = 0
_LIBCUDA = []


def _log(msg: str) -> None:
    print(f"[aot] {msg}", file=sys.stderr, flush=True)


def _field():
    from ..ops import field  # the kernels' launch counters and mul choice

    return field


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype).replace("torch.", ""), str(x.device))
    return ("static", repr(x))


def _structure(tree):
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(t) for t in tree))
    return "*"


def _arg_key(args) -> tuple:
    """The JAX _arg_key: structure plus (shape, dtype, device) per leaf;
    with the selected field multiply."""
    return (_structure(args), tuple(_leaf_key(x) for x in tree_leaves(args)),
            _field().selected_mul().name)


def key_str(key) -> str:
    """A key as a short line: runs of equal leaves folded, e.g.
    `int32[25,524288]x6 int32[25,1]x4 cuda:0 mont_mul`."""
    parts, devices = [], set()
    for leaf in key[1]:
        if leaf[0] == "static":
            s = leaf[1]
        else:
            s = f"{leaf[1]}[{','.join(map(str, leaf[0]))}]"
            devices.add(leaf[2])
        if parts and parts[-1][0] == s:
            parts[-1][1] += 1
        else:
            parts.append([s, 1])
    text = " ".join(s if k == 1 else f"{s}x{k}" for s, k in parts)
    return f"{text} {' '.join(sorted(devices))} {key[2]}"


def _kernel_nodes(graph) -> "int | None":
    """Kernel nodes of a captured (kept) graph, counted with libcuda's
    cuGraphGetNodes and cuGraphNodeGetType; None where libcuda cannot be
    loaded."""
    if not _LIBCUDA:
        try:
            _LIBCUDA.append(ctypes.CDLL("libcuda.so.1"))
        except OSError:
            _LIBCUDA.append(None)
    cu = _LIBCUDA[0]
    if cu is None:
        return None
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(count)):
        return None
    nodes = (ctypes.c_void_p * count.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)):
        return None
    kind = ctypes.c_int(0)
    kernels = 0
    for node in nodes:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            return None
        kernels += kind.value == _CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


class _Pool:
    """The memory pool the graphs of one device share, with the bytes it
    has grown by and the most it may keep."""

    def __init__(self, device):
        self.handle = torch.cuda.graph_pool_handle()
        self.bytes = 0
        self.limit = int(POOL_SHARE * torch.cuda.get_device_properties(device).total_memory)


class Entry:
    """One captured program: the graph, its static inputs and outputs, and
    what its capture measured."""

    def __init__(self, jit, key, device, graph, inputs, outputs, info, pairs):
        self.jit = jit
        self.key = key
        self.device = device
        self.graph = graph
        self.inputs = inputs      # the static argument tree
        self.outputs = outputs    # the graph's output tree
        self.info = info          # capture_s, kernels, port_kernels, pool_bytes, spans
        self.pairs = pairs        # the device spans' events that each replay records
        self.replays = 0

    @property
    def mul(self) -> str:
        """The field multiply the graph was captured with (its kernel name)."""
        return self.key[2]


class AotJit:
    """A function run as one captured CUDA graph per key (the JAX AotJit's
    contract, with graphs in place of executables)."""

    def __init__(self, tag: str, fn, owners=()):
        self.tag = tag
        self.fn = fn
        self.owners = owners  # what fn closes over, kept alive for jit()'s key
        self.entries = {}  # key -> Entry
        self.seen = set()  # keys whose first (eager) call has run
        with _LOCK:
            _ALL.append(weakref.ref(self))

    def _device(self, args):
        """The one CUDA device of args' tensors, or None when they are all
        on the CPU."""
        kinds = {x.device.type for x in tree_leaves(args) if isinstance(x, torch.Tensor)}
        if kinds == {"cpu"}:
            return None
        if kinds != {"cuda"}:
            raise ValueError(f"[aot] {self.tag}: takes tensors all on the CPU or "
                             f"all on CUDA cards, got {sorted(kinds) or 'none'}")
        return next(x.device for x in tree_leaves(args) if isinstance(x, torch.Tensor))

    def __call__(self, *args):
        device = self._device(args)
        if device is None:
            return self.fn(*args)
        key = _arg_key(args)
        with _LOCK:
            entry = self.entries.get(key)
            if entry is None:
                if key not in self.seen:
                    self.seen.add(key)
                    with torch.cuda.device(device):
                        return self.fn(*args)
                entry = self._capture(key, args, device)
            return self._replay(entry, args)

    def prepare(self, *args) -> "Entry | None":
        """The graph of args' key, captured now if it was not (after one
        eager run of fn if the key is new), without a replay; None for CPU
        tensors."""
        device = self._device(args)
        if device is None:
            return None
        key = _arg_key(args)
        with _LOCK:
            entry = self.entries.get(key)
            if entry is None:
                if key not in self.seen:
                    self.seen.add(key)
                    with torch.cuda.device(device):
                        self.fn(*args)
                entry = self._capture(key, args, device)
            return entry

    def _capture(self, key, args, device) -> Entry:
        field = _field()
        pool = _POOLS.get(device)
        if pool is not None and pool.bytes > pool.limit:
            _drop(device, f"pool {pool.bytes} bytes past its limit {pool.limit}")
            pool = None
        before = {k.name: (k.launches, dict(k.launches_by_n)) for k in field.KERNELS}
        try:
            with torch.cuda.device(device):
                inputs = tree_map(
                    lambda x: x.clone() if isinstance(x, torch.Tensor) else x, args)
                torch.cuda.synchronize(device)
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(device)
                t0 = time.perf_counter()
                if pool is None:
                    pool = _POOLS[device] = _Pool(device)
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                with (torch.cuda.graph(graph, pool=pool.handle,
                                       capture_error_mode="thread_local"),
                      profiling.collect_spans() as pairs,
                      profiling.device_span("gpu.graph", inputs)):
                    outputs = self.fn(*inputs)
                kernels = _kernel_nodes(graph)
                graph.instantiate()
                torch.cuda.synchronize(device)
                capture_s = time.perf_counter() - t0
                grown = torch.cuda.memory_reserved(device) - reserved
        except Exception as e:
            raise RuntimeError(
                f"[aot] capture of {self.tag} failed at key {key_str(key)}: {e}") from e
        finally:
            # the capture recorded these launches; replays count them
            port = {}
            for k in field.KERNELS:
                n, by_n = before[k.name]
                if k.launches > n:
                    port[k.name] = k.launches - n
                k.launches, k.launches_by_n = n, by_n
        pool.bytes += grown
        info = {"capture_s": capture_s, "kernels": kernels, "port_kernels": port,
                "pool_bytes": grown, "spans": [p.name for p in pairs]}
        _log(f"MISS {self.tag} {key_str(key)} captured in {capture_s:.2f} s, "
             f"{'not measured' if kernels is None else kernels} kernels, "
             f"pool +{grown} bytes")
        entry = self.entries[key] = Entry(self, key, device, graph, inputs, outputs, info,
                                          pairs)
        return entry

    def _replay(self, entry: Entry, args):
        try:
            for dst, src in zip(tree_leaves(entry.inputs), tree_leaves(args)):
                if isinstance(src, torch.Tensor) and src is not dst:
                    dst.copy_(src)
            # the previous replay's device spans, read before this one
            # records them again
            profiling.settle(entry.pairs)
            with profiling.stage("aot.launch", f"aot.launch:{self.tag}"):
                entry.graph.replay()
            profiling.arm(entry.pairs)
            out = tree_map(lambda t: t.clone(), entry.outputs)
        except Exception as e:
            raise RuntimeError(
                f"[aot] replay of {self.tag} failed at key {key_str(entry.key)}: {e}"
            ) from e
        entry.replays += 1
        for name, n in entry.info["port_kernels"].items():
            _REPLAYED[name] = _REPLAYED.get(name, 0) + n
        return out


def jit(tag: str, fn, *owners) -> AotJit:
    """The process's AotJit for (tag, owners), made from fn at its first
    use. The tag names every static value fn closes over (ints, strings), as
    the JAX tags do; the objects it closes over (a curve, a field's ops) are
    the owners, told apart by identity. So one (tag, owners) is one
    program."""
    with _LOCK:
        k = (tag, *map(id, owners))
        j = _BY_TAG.get(k)
        if j is None:
            j = _BY_TAG[k] = AotJit(tag, fn, owners)
        return j


def _jits() -> list:
    """Every live AotJit, oldest first (forgetting those collected)."""
    _ALL[:] = [r for r in _ALL if r() is not None]
    return [j for j in (r() for r in _ALL) if j is not None]


def entries() -> list:
    """Every captured program of the process, oldest AotJit first."""
    with _LOCK:
        return [e for j in _jits() for e in j.entries.values()]


def graph_launches() -> dict:
    """The port's kernel launches that replays ran since reset_replays():
    per kernel, each replay's captured launches summed. The kernels' own
    counters (ops/field.py) count the launches that ran from Python."""
    with _LOCK:
        return dict(_REPLAYED)


def reset_replays() -> None:
    with _LOCK:
        _REPLAYED.clear()
        for e in entries():
            e.replays = 0


def _drop(device, why: str) -> None:
    """Drop every graph on `device`, and with them its pool."""
    n = 0
    for j in _jits():
        for key in [k for k, e in j.entries.items() if e.device == device]:
            del j.entries[key]
            n += 1
    _POOLS.pop(device, None)
    torch.cuda.empty_cache()
    _log(f"DROP {n} graphs on {device}: {why}")


def clear() -> None:
    """Drop every captured graph of the process, and with them the pools,
    and forget the keys seen: the next call of a key runs eagerly again."""
    with _LOCK:
        for j in _jits():
            j.entries.clear()
            j.seen.clear()
        _POOLS.clear()
