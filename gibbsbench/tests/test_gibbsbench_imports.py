"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program either; names are
compared by their top-level part as a whole."""

import os
import subprocess
import sys

from gibbsbench import importcheck

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_static_scan_is_clean():
    assert importcheck.violations(os.path.join(ROOT, "gibbsbench")) == []


def test_scan_catches_a_planted_import(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "a.py").write_text("import jax.numpy as jnp\n"
                                   "import numbskull_tpu_torch.ops\n")
    (tmp_path / "b.py").write_text("from numbskull_tpu.ops import x\n")
    (tmp_path / "reference" / "r.py").write_text(
        "from numbskull_tpu_torch import golden\n"
        "import importlib\nimportlib.import_module('jaxlib')\n")
    assert importcheck.violations(str(tmp_path)) == [
        ("a.py", "jax"), ("b.py", "numbskull_tpu"),
        ("reference/r.py", "jaxlib"), ("reference/r.py",
                                       "numbskull_tpu_torch")]


def test_top_level_names_compared_whole():
    assert importcheck.loaded_forbidden(
        ["numbskull_tpu_torch", "numbskull_tpu_torch.ops.itemgrid",
         "jaxtyping", "flaxen"]) == []
    assert importcheck.loaded_forbidden(
        ["jax._src", "numbskull_tpu.compile", "flax"]) == [
        "flax", "jax", "numbskull_tpu"]


def test_dry_run_loads_no_jax():
    """A tiny cell's run on the CPU, in a fresh process, leaves nothing
    forbidden in ``sys.modules``."""
    code = ("import sys; from gibbsbench.tests.helpers import run_tiny; "
            "from gibbsbench.importcheck import loaded_forbidden; "
            "run_tiny('ehr.learn'); print(loaded_forbidden(sys.modules))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
