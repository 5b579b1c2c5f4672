"""Nothing the benchmark runs loads JAX, flax or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""
import ast
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "sound_event_detection_transformer_tpu"}
PORT = "sound_event_detection_transformer_tpu_torch"


def modules():
    for path in sorted(HERE.rglob("*.py")):
        rel = path.relative_to(HERE.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if "tests" not in parts:
            yield ".".join(parts)


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_bench_no_module_imports_jax():
    names = list(modules())
    code = ("import sys, json; sys.path.insert(0, %r)\n" % str(HERE.parent)
            + "".join(f"import {n}\n" for n in names)
            + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=HERE.parent)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PORT in tops and "benchmark" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    for path in HERE.rglob("*.py"):
        assert not set(imported_tops(path)) & FORBIDDEN, path


def test_bench_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").rglob("*.py"):
        tops = set(imported_tops(path))
        assert PORT not in tops and not tops & FORBIDDEN, path
        assert "benchmark" not in tops, path  # only relative imports inside the benchmark
    # the modules the reference reaches by relative import
    for rel in ("traffic.py", "reference/params.py"):
        assert not {PORT} & set(imported_tops(HERE / rel)), rel
