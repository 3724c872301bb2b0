"""The port's examples (celo_bls_snark_tpu_torch/examples/) against the JAX
package's: simple_signature, pop, pop_csv -n 2 and constraints 1 0 run as
`python -m`-style modules in one subprocess a package (the two side by
side), with the OS entropy of simple_signature and pop_csv replaced by
fixed bytes, and print the same text. proof.py sets up and proves an epoch
circuit, hours on the CPU: chip_smoke.py's epoch_snark phase runs that
path on the card."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SK_HEX = (123456789123456789123456789).to_bytes(32, "little").hex()
EXAMPLES = [
    ("simple_signature", ["-m", "an example message"]),
    ("pop", ["-k", SK_HEX]),
    ("pop_csv", ["-n", "2", "-o", "{out}"]),
    ("constraints", ["1", "0"]),  # 1 1 takes 30 s a package, 1 0 about 3
]
RUNNER = """
import ast, runpy, secrets, sys
secrets.token_bytes = lambda n: bytes((7 * i + 1) % 256 for i in range(n))
pkg, out, examples = sys.argv[1], sys.argv[2], ast.literal_eval(sys.argv[3])
for name, args in examples:
    print("=== " + name, flush=True)
    sys.argv = [name] + [a.format(out=out) for a in args]
    runpy.run_module(pkg + ".examples." + name, run_name="__main__")
    if name == "pop_csv":
        print(open(out).read(), end="")
"""


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", RUNNER, pkg, str(tmp / f"{pkg}.csv"), repr(EXAMPLES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO, text=True)
        for pkg in ("celo_bls_snark_tpu", "celo_bls_snark_tpu_torch")}
    texts = {}
    try:
        for pkg, p in procs.items():
            texts[pkg] = p.communicate(timeout=300)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for pkg, p in procs.items():
        assert p.returncode == 0, texts[pkg][-4000:]
    return {pkg: dict(part.split("\n", 1) for part in text.split("=== ")[1:])
            for pkg, text in texts.items()}


@pytest.mark.parametrize("name,marker", [
    ("simple_signature", "aggregated signature verified successfully"),
    ("pop", ""),
    ("pop_csv", ","),
    ("constraints", "Number of constraints for 0 epochs"),
])
def test_example_prints_what_the_jax_package_prints(outputs, name, marker):
    port = outputs["celo_bls_snark_tpu_torch"][name]
    assert port == outputs["celo_bls_snark_tpu"][name]
    assert port.strip() and marker in port
