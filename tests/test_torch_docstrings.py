"""The part of ``ci-torch.yml``'s ``docs-lint`` job that needs no ruff: every
public module, class, function and method of the port's profiling surface
has a docstring (ruff's D100-D103 and D106; D105 and D107 are ignored in
``pyproject.toml``'s ``[tool.ruff.lint]``).  Read with ``ast``; nothing is
imported.  The style rules (D2xx, D4xx) are the job's alone."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
#: the port's counterparts of ``ci.yml``'s docs-lint files
FILES = tuple(f"core/{m}.py" for m in (
    "api", "session", "render", "advisor", "tuner", "cache", "check", "lint",
    "resilience", "faultinject")) + ("cli.py",)


def undocumented(tree):
    """(public definitions, ``line name`` of those without a docstring) of
    a module: its top-level functions and classes whose names do not start
    with ``_``, and the public methods and nested classes of public
    classes, magic methods aside."""
    seen, missing = 0, []

    def visit(body, in_class):
        nonlocal seen
        for node in body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if node.name.startswith("_"):
                continue
            seen += 1
            if ast.get_docstring(node) is None:
                missing.append(f"{node.lineno} {node.name}")
            if isinstance(node, ast.ClassDef):
                visit(node.body, True)

    visit(tree.body, False)
    return seen, missing


@pytest.mark.parametrize("rel", FILES)
def test_every_public_definition_has_a_docstring(rel):
    tree = ast.parse((PORT / rel).read_text())
    assert ast.get_docstring(tree), f"{rel}: no module docstring"
    seen, missing = undocumented(tree)
    assert seen and not missing, f"{rel}: no docstring on {missing}"


def test_ci_torch_docs_lint_job_checks_the_same_files():
    text = (ROOT / ".github" / "workflows" / "ci-torch.yml").read_text()
    job = re.search(r"\n  docs-lint:\n(.*?)(?=\n  [\w-]+:\n|\Z)", text, re.S)
    assert job, "ci-torch.yml has no docs-lint job"
    assert "ruff check --select D" in job.group(1)
    listed = re.findall(r"src/repro_torch/(\S+\.py)", job.group(1))
    assert sorted(listed) == sorted(FILES)
