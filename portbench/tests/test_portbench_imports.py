"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def test_a_small_run_loads_no_jax():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "import portbench.run as R, portbench.control\n"
        "from portbench.tests.small import adjust\n"
        "res = R.evaluate('base.offline-b16', 3, 0.5, 1, device='cpu', adjust=adjust)\n"
        "assert res['attempted'] > 0\n"
        "print(R.forbidden_modules())\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS",)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names():
    import portbench.run as R

    saved = dict(sys.modules)
    try:
        sys.modules["jyutvoice_tpu_torch_extra"] = sys
        sys.modules["jaxtyping"] = sys
        assert R.forbidden_modules() == [] or "jax" in saved or "jyutvoice_tpu" in saved
        sys.modules["jyutvoice_tpu.models"] = sys
        assert "jyutvoice_tpu" in R.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_reference_imports_nothing_of_the_program():
    for name in sorted(os.listdir(os.path.join(HERE, "reference"))):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(HERE, "reference", name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for m in mods:
                top = m.split(".")[0]
                assert top in ("torch", "numpy", "math", "re", "dataclasses", "typing",
                               "__future__", "portbench"), (name, m)
                assert not m.startswith("portbench") or m.startswith("portbench.reference"), (name, m)
