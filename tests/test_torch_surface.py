"""The port's surface against the JAX package's, read from source.

Every module of ``src/repro`` has a module at the same relative path in
``src/repro_torch``; every public top-level function, class or constant
of a reference module has a counterpart there (the same name, a rename in
:data:`RENAMED`, or an entry in ``docs/port.md``'s "Reference modules
with no one-to-one counterpart" that says why there is none); and every
subcommand and option of the reference's CLI parser is in the port's.

Both packages are read with ``ast`` and neither is imported, so the test
runs where JAX is not installed.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
DOC = ROOT / "docs" / "port.md"
DOC_SECTION = "## Reference modules with no one-to-one counterpart"

#: reference ``module:name`` -> its port counterparts (``module:name``),
#: where the port names the same thing otherwise
RENAMED = {
    # the pytree aliases: the port's trees are dicts of tensors
    "checkpoint/manager.py:PyTree": ("checkpoint/manager.py:Tree",),
    "optim/optimizers.py:PyTree": ("optim/optimizers.py:Tree",),
    "parallel/compression.py:PyTree": ("parallel/compression.py:Tree",),
    "runtime/train_loop.py:PyTree": ("runtime/train_loop.py:Tree",),
    # the HLO sweep counts the aten ops a pass dispatches in the port
    "core/model_profile.py:hlo_sweep": ("core/model_profile.py:op_sweep",),
    # a TPU's ICI link rate -> an H100's NVLink rate each way
    "core/roofline.py:ICI_BW_PER_LINK": ("core/roofline.py:LINK_BW",),
    # the reference's only geometry is the TPU tile; the port has two
    "core/tiles.py:TileGeometry": ("core/tiles.py:TPUTile",),
    "core/tiles.py:words_per_sector": ("core/tiles.py:sublanes_for",),
    # the pure-jnp oracles are the port's plain versions
    "kernels/gmm.py:gmm_ref": ("kernels/gmm.py:gmm_plain",),
    "kernels/paged_attn.py:paged_decode_reference": ("kernels/paged_attn.py:paged_decode_ref",),
    "kernels/ragged_flash.py:ragged_decode_reference": (
        "kernels/ragged_flash.py:ragged_decode_ref",
    ),
    # one Pallas entry with a use_scratch flag -> one wrapper per kernel
    "kernels/ttm.py:ttm": ("kernels/ttm.py:ttm_fused", "kernels/ttm.py:ttm_scratch"),
    # ShapeDtypeStruct stand-ins -> the same builders on the meta device
    "models/attention.py:abstract_cache": ("models/attention.py:init_cache",),
    "models/attention.py:abstract_mla_cache": ("models/attention.py:init_mla_cache",),
    "models/mamba.py:abstract_mamba_cache": ("models/mamba.py:init_mamba_cache",),
    "models/params.py:abstract_params": ("models/params.py:materialize",),
    # NamedSharding trees -> DTensor placements, laid out by distribute_params
    "parallel/sharding.py:shardings_from_logical": (
        "parallel/sharding.py:distribute_params", "parallel/sharding.py:placements",
    ),
}


def _modules(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py"))


def _bindings(path):
    """{name: kind} of a module's top-level bindings: ``def``, ``class``,
    assignment (``const``) and import (``import``)."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = "def"
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for e in t.elts if isinstance(t, ast.Tuple) else [t]:
                    if isinstance(e, ast.Name):
                        out[e.id] = "const"
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out.setdefault((a.asname or a.name).split(".")[0], "import")
    return out


def _public(path):
    """The public functions, classes and constants a module defines."""
    return sorted(n for n, kind in _bindings(path).items()
                  if kind != "import" and not n.startswith("_"))


def _doc_exceptions():
    """{``module`` or ``module:name``: why} from docs/port.md's section."""
    text = DOC.read_text()
    assert DOC_SECTION in text, f"docs/port.md lacks {DOC_SECTION!r}"
    section = text.split(DOC_SECTION, 1)[1].split("\n## ", 1)[0]
    out = {}
    for item in re.split(r"\n(?=- )", section.strip()):
        m = re.match(r"- \*\*(.+?)\*\*(.*)", item, re.S)
        if not m:
            continue
        why = " ".join(m.group(2).split())
        for ref in re.findall(r"`([\w/]+\.py(?::\w+)?)`", m.group(1)):
            out[ref] = why
    return out


REF_MODULES = _modules(REF)
EXCEPTIONS = _doc_exceptions()


def test_the_reference_and_the_port_are_read():
    assert len(REF_MODULES) > 50 and "cli.py" in REF_MODULES
    assert "core/hlo_cost.py" in EXCEPTIONS


@pytest.mark.parametrize("module", REF_MODULES)
def test_module_has_a_counterpart(module):
    assert (PORT / module).is_file() or module in EXCEPTIONS, (
        f"src/repro/{module} has no src/repro_torch/{module} and no entry in "
        f"docs/port.md's {DOC_SECTION[3:]!r}"
    )


@pytest.mark.parametrize(
    "module", [m for m in REF_MODULES if m not in EXCEPTIONS and _public(REF / m)]
)
def test_public_names_have_counterparts(module):
    port = _bindings(PORT / module)
    missing = []
    for name in _public(REF / module):
        key = f"{module}:{name}"
        if name in port or key in EXCEPTIONS:
            continue
        if key in RENAMED:
            for other in RENAMED[key]:
                where, new = other.split(":")
                assert new in _bindings(PORT / where), f"{key} -> {other}: no such name"
            continue
        missing.append(name)
    assert not missing, (
        f"src/repro/{module} defines {missing}, which src/repro_torch/{module} "
        f"lacks: port them, add a rename to RENAMED, or say in docs/port.md why "
        f"there is none"
    )


def test_every_exception_names_what_the_port_lacks_and_says_why():
    """An entry that no longer names a gap, or says nothing, is stale."""
    for ref, why in EXCEPTIONS.items():
        module, _, name = ref.partition(":")
        assert len(why.split()) >= 8, f"docs/port.md's entry for {ref} says no why"
        assert (REF / module).is_file(), f"{ref}: no src/repro/{module}"
        if name:
            assert name in _public(REF / module), f"{ref}: the reference has no {name}"
            assert name not in _bindings(PORT / module), f"{ref}: the port has it"
        else:
            assert not (PORT / module).exists(), f"{ref}: the port has the module"


def test_every_rename_is_of_a_name_the_port_does_not_share():
    for key in RENAMED:
        module, name = key.split(":")
        assert name in _public(REF / module), f"{key}: the reference has no {name}"
        assert name not in _bindings(PORT / module), f"{key}: the port has the name"
        assert key not in EXCEPTIONS, f"{key} is both renamed and an exception"


# -- the CLI --------------------------------------------------------------------


def _str_args(call):
    return [a.value for a in call.args if isinstance(a, ast.Constant) and isinstance(a.value, str)]


def _helper_options(fn, call):
    """The option strings a helper such as ``_add_device(parser, ...)``
    adds for this call; a branch ``if PARAM is not None:`` counts only
    when the call passes something other than None for PARAM."""
    params = [a.arg for a in fn.args.args]
    given = dict(zip(params, call.args))
    given.update({k.arg: k.value for k in call.keywords})

    def walk(stmts):
        for st in stmts:
            if isinstance(st, ast.If):
                t = st.test
                if (isinstance(t, ast.Compare) and isinstance(t.left, ast.Name)
                        and isinstance(t.ops[0], ast.IsNot)
                        and isinstance(t.comparators[0], ast.Constant)
                        and t.comparators[0].value is None):
                    arg = given.get(t.left.id)
                    if arg is None or (isinstance(arg, ast.Constant) and arg.value is None):
                        yield from walk(st.orelse)
                        continue
                yield from walk(st.body)
                yield from walk(st.orelse)
                continue
            for node in ast.walk(st):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "add_argument"):
                    yield from _str_args(node)

    return set(walk(fn.body))


def _cli_surface(path):
    """{subcommand: its option and positional names} of a ``cli.py``'s
    ``_build_parser``, helpers that add options included."""
    tree = ast.parse(path.read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    var_of = {}
    out = {}
    for node in ast.walk(fns["_build_parser"]):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute)
                and node.value.func.attr == "add_parser"):
            name = _str_args(node.value)[0]
            var_of[node.targets[0].id] = name
            out[name] = set()
    for node in ast.walk(fns["_build_parser"]):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr == "add_argument"
                and isinstance(f.value, ast.Name) and f.value.id in var_of):
            out[var_of[f.value.id]].update(_str_args(node))
        elif (isinstance(f, ast.Name) and f.id in fns and node.args
              and isinstance(node.args[0], ast.Name) and node.args[0].id in var_of):
            out[var_of[node.args[0].id]].update(_helper_options(fns[f.id], node))
    return out


REF_CLI = _cli_surface(REF / "cli.py")
PORT_CLI = _cli_surface(PORT / "cli.py")


def test_the_parsers_are_read():
    assert set(REF_CLI) >= {"kernels", "lint", "profile", "model", "report", "diff",
                            "check", "tune"}
    assert {"--device", "--cache", "--workers", "--inject-faults"} <= PORT_CLI["profile"]
    # _add_scale_out adds --resume only where the command keeps a journal
    assert "--resume" in PORT_CLI["tune"] and "--resume" not in PORT_CLI["profile"]


@pytest.mark.parametrize("command", sorted(REF_CLI))
def test_subcommand_and_its_options_are_in_the_port(command):
    assert command in PORT_CLI, f"the port's CLI has no {command!r}"
    missing = sorted(REF_CLI[command] - PORT_CLI[command])
    assert not missing, f"{command}: the port's parser lacks {missing}"
