"""What a run loads: no JAX, no flax, no stardist_tpu (whole top-level
names), and the reference nothing of stardist_torch."""
import ast
import subprocess
import sys

from portbench import manifest

BANNED = {"jax", "jaxlib", "flax", "stardist_tpu"}
HERE = manifest.HERE


def loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=HERE.parent, capture_output=True, text=True, check=True)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    top = loaded_after("import portbench.run as r, portbench.window, portbench.trace, "
                       "portbench.flops, portbench.frozen, portbench.reference.pipeline\n"
                       "import stardist_torch.models")
    assert "stardist_torch" in top and "portbench" in top
    assert not top & BANNED


def test_the_reference_loads_nothing_of_the_program():
    top = loaded_after("import portbench.reference.pipeline")
    assert "stardist_torch" not in top and not top & BANNED
    for f in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in BANNED | {"stardist_torch", "portbench"}, (f, n)


def test_the_banned_check_compares_whole_names():
    sys.path.insert(0, str(HERE))
    import run
    assert run.BANNED == ("jax", "jaxlib", "flax", "stardist_tpu")
    assert "stardist_torch" not in run.banned_modules()
