"""The JAX package's answers on the fixed inputs of the port's costliest
comparison tests, recorded once in files under tests/jax_recordings/.

The JAX package is the frozen reference, so its answer on inputs that a
test fixes never changes; compiling it on the CPU to get that answer costs
30-350 s a shape. A test module that compares the port with such an
answer declares its recorded cases once:

    REC = jax_answers.Recordings(__name__, {"case": (inputs, jax_fn)})

`inputs()` builds the case's host-level inputs (points, integers, bytes,
numpy arrays), the same ones the port is given; `jax_fn(inputs)` runs the
JAX package on them and returns a dict of lists of numpy arrays (limbs,
or bool arrays of verdicts), kept in `<module>.<case>.npz` with the
digest of the inputs they were made from. Only the costly cases are
recorded: a comparison whose JAX side compiles in under about 30 s stays
live.

- `REC.answers(case, inputs, jax_fn)` returns the recorded answers of a
  recorded case and runs `jax_fn` live for any other.
- `REC.load(case, inputs)` returns the recorded answers, after checking
  that `inputs` digest to the recorded digest: changed inputs raise
  StaleRecording, naming the file and the command that re-derives it.
- `REC.rederive(case)` runs the JAX package on the case's inputs and
  asserts that the file holds its answers, limb for limb.
  tests/test_jax_answers.py runs it for every recording in a test marked
  `slow`, outside the Tier-1 gate:
  `pytest tests/test_jax_answers.py -m slow -p xdist -n 6 --dist load`.
- `python tests/jax_answers.py [module[.case] ...]` rewrites the named
  recordings (default: every module that has one). Nothing else writes
  them; a test never does.
"""

import hashlib
import os
import sys

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_recordings")


class StaleRecording(AssertionError):
    """A recording that is missing or was made from other inputs."""


def digest(obj) -> str:
    """sha256 of a canonical encoding of nested host-level inputs."""
    h = hashlib.sha256()
    _encode(obj, h.update)
    return h.hexdigest()


def _encode(obj, put):
    if obj is None:
        put(b"N")
    elif isinstance(obj, (bool, np.bool_)):
        put(b"T" if obj else b"F")
    elif isinstance(obj, (int, np.integer)):
        put(b"I%d;" % int(obj))
    elif isinstance(obj, bytes):
        put(b"Y%d:" % len(obj) + obj)
    elif isinstance(obj, str):
        _encode(obj.encode(), lambda b: put(b"S" + b))
    elif isinstance(obj, np.ndarray):
        put(f"A{obj.dtype.str}{obj.shape}:".encode())
        put(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, (tuple, list)):
        put(b"L%d[" % len(obj))
        for x in obj:
            _encode(x, put)
        put(b"]")
    elif isinstance(obj, dict):
        _encode(sorted(obj.items()), lambda b: put(b"D" + b))
    else:
        raise TypeError(f"cannot digest {type(obj).__name__}")


def recorded() -> list:
    """`module.case` of every recording on disk."""
    return sorted(f.rpartition(".")[0] for f in os.listdir(DATA))


class Recordings:
    """One test module's recorded cases: {case: (inputs, jax_fn)}."""

    def __init__(self, module: str, cases: dict):
        self.module = module.rpartition(".")[2]
        self.cases = cases

    def path(self, case: str) -> str:
        return os.path.join(DATA, f"{self.module}.{case}.npz")

    def command(self, case: str) -> str:
        return f"python tests/jax_answers.py {self.module}.{case}"

    def answers(self, case: str, inputs, jax_fn) -> dict:
        """Recorded for a recorded case, live (`jax_fn`) for the others."""
        return self.load(case, inputs) if case in self.cases else jax_fn(inputs)

    def load(self, case: str, inputs) -> dict:
        path = self.path(case)
        if not os.path.exists(path):
            raise StaleRecording(f"{path} is missing; record it with "
                                 f"`{self.command(case)}`")
        answers = {}
        with np.load(path) as z:
            saved_digest = str(z["digest"])
            for key in z.files:
                if key != "digest":
                    name, _, i = key.rpartition("/")
                    answers.setdefault(name, {})[int(i)] = z[key]
        got = digest(inputs)
        if got != saved_digest:
            raise StaleRecording(
                f"{path} was recorded from inputs with digest {saved_digest[:16]}, "
                f"but these inputs digest to {got[:16]}; re-derive it with "
                f"`{self.command(case)}`")
        return {k: [v[i] for i in sorted(v)] for k, v in answers.items()}

    def write(self, case: str) -> str:
        inputs_fn, jax_fn = self.cases[case]
        inputs = inputs_fn()
        answers = jax_fn(inputs)
        arrays = {f"{k}/{i}": x for k, v in answers.items() for i, x in enumerate(v)}
        os.makedirs(DATA, exist_ok=True)
        np.savez_compressed(self.path(case), digest=np.array(digest(inputs)), **arrays)
        return self.path(case)

    def rederive(self, case: str):
        inputs_fn, jax_fn = self.cases[case]
        inputs = inputs_fn()
        fresh = jax_fn(inputs)
        saved = self.load(case, inputs)
        assert sorted(fresh) == sorted(saved), case
        for key, value in fresh.items():
            assert len(value) == len(saved[key]), (case, key)
            for x, y in zip(value, saved[key]):
                assert x.dtype == y.dtype, (case, key)
                np.testing.assert_array_equal(x, y, err_msg=f"{case} {key}")


def main(argv):
    """Rewrite the named recordings: `module` for all of a module's cases,
    `module.case` for one; no name rewrites every module that has one."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.dirname(here)]
    import importlib

    import conftest  # noqa: F401  the tests' JAX-on-CPU set-up

    names = argv or sorted({name.split(".")[0] for name in recorded()})
    for name in names:
        module, _, case = name.partition(".")
        rec = importlib.import_module(module).REC
        for c in [case] if case else sorted(rec.cases):
            path = rec.write(c)
            print(f"{path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main(sys.argv[1:])
