"""The import check: no file of the benchmark imports JAX or the JAX
package, the reference and the generators import nothing of the program,
and a run loads none of them."""
import subprocess
import sys

from portbench import check_imports, harness


def test_no_file_imports_what_it_must_not():
    assert check_imports.offences() == []


def test_names_are_compared_whole():
    assert "repro_torch" not in check_imports.NEVER
    assert "repro" in check_imports.NEVER


def test_a_run_loads_no_jax():
    paths = [str(harness.ROOT), str(harness.ROOT / "src")]
    code = (
        "import sys, dataclasses, torch\n"
        f"sys.path[:0] = {paths!r}\n"
        "from portbench import harness\n"
        "c = harness.find_cell('nf-f32.refit')\n"
        "c = dataclasses.replace(c, config={**c.config, 'grid_points': 64})\n"
        "harness.run_cell(c, 1, 0.2, False, torch.device('cpu'))\n"
        "print(harness.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"
