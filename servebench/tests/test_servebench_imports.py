"""Nothing under servebench/ imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is the program), and
the reference imports nothing of the program."""
import ast

from servebench import guard, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = list(spec.HERE.rglob("*.py"))
    assert len(files) > 15
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN, f


def test_the_reference_imports_torch_alone():
    for f in (spec.HERE / "reference").rglob("*.py"):
        names = set(_imports(f))
        assert "repro_torch" not in names, f
        assert names <= {"__future__", "torch"}, (f, names)


def test_the_module_guard_compares_whole_names():
    assert guard.forbidden_modules(["repro_torch", "repro_torch.core",
                                    "reprox", "jax_free"]) == []
    assert guard.forbidden_modules(["repro.core.client", "jaxlib.xla",
                                    "numpy"]) == ["jaxlib", "repro"]
