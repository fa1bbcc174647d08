"""The port covers the JAX package's public surface.

Parses both packages' sources with `ast` (importing neither) and holds the
port to the JAX package's public names, one case per JAX module:

* every `*.py` of the JAX package has a port module of the same relative
  path; `ops/pallas/{fc_forward,merger,merger_int}.py` map to port
  `ops/{fc_forward,merger,merger_int}.py` (the hand-written Hopper
  kernels' wrappers), and `ops/pallas/__init__.py` needs none;
* every public name of a JAX module is bound in its port module.  The
  public names are the top-level `def`s and `class`es, the public methods
  of public classes and the UPPER_CASE module constants (top-level
  statements, those under `if` and `try` included).  A `def`, a `class`,
  an assignment or an `import ... as` binds a name in the port; a method
  is bound by its port class's body (or a base class of the same module);
* an environment variable a JAX module reads (a string constant
  `CANP_*`) is a public name too: the port reads none (a case checks it)
  and takes each as an argument instead, a parameter of a function of the
  port module (`KNOBS`).

The only exceptions are the entries of `EXCLUDED`, keyed "path:name",
each with its reason: they are the list of what the port leaves out.  A
case checks that every entry still names something the JAX module
defines and the port module lacks, so no entry outlives its reason.
"""

import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX = REPO / "context_adaptive_neural_network_based_prediction_tpu"
PORT = REPO / "context_adaptive_neural_network_based_prediction_tpu_torch"
UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")
KNOB = re.compile(r"^CANP_[A-Z0-9_]+$")

# JAX module -> port module where the paths differ; None: no counterpart.
MODULE_MAP = {
    "ops/pallas/__init__.py": None,
    "ops/pallas/fc_forward.py": "ops/fc_forward.py",
    "ops/pallas/merger.py": "ops/merger.py",
    "ops/pallas/merger_int.py": "ops/merger_int.py",
}

# "JAX module:CANP_* variable" -> the port's parameter that replaces it.
KNOBS = {
    "parallel/wavefront2.py:CANP_RATE_EVOLVE": "rate_evolve",
    "parallel/wavefront2.py:CANP_FUSED_UNIT": "impl",
    "models/pnn_q.py:CANP_PALLAS": "impl",
}

_TF = ("needs TensorFlow, which neither machine has; the repository holds "
       "no TF checkpoint, and the JAX side cannot run here to hold a port "
       "against.  Waits until TensorFlow and a checkpoint are in the "
       "repository (ROADMAP A, 'Waiting').")
_PALLAS = ("a Pallas tiling constant or entry point of the TPU kernel; the "
           "port's hand-written Hopper kernel behind `ops/{0}.py` has its "
           "own tiling (`ops/csrc/{0}.cu`{1}) and its wrapper is `{2}`.")
_CAL = ("the JAX package's evolved-context calibration of the static rate "
        "tables, an experiment gated off there: its snapshot steers worse "
        "than HM's initial states (+17.8% vs +12.7% BD on parkscene, and "
        "+12.98% vs +10.86% even when calibrated on the same frame; "
        "RESULTS.md, rate-model findings).  The port's tables start from "
        "HM's initial states (`rate_model._states`).")
_KNOB = ("an experiment knob of the JAX package that {0}; a port run never "
         "gives wrong outputs silently and reads no environment variable.")

EXCLUDED = {
    "models/importer.py:load_tf_checkpoint_arrays": _TF,
    "models/importer.py:convert_checkpoint_to_npz": _TF,
    "codec/nn_intra.py:PnnBundle.from_checkpoints": _TF,
    "codec/native.py:available":
        "the JAX package's probe for its Python fallback; the port has no "
        "fallback (a native failure raises), so there is nothing to probe.",
    "codec/native.py:deblock_native":
        "the port's `native.deblock_luma` / `deblock_chroma` (HM "
        "deblocking in one native call, luma and chroma as two entry "
        "points).",
    "models/training.py:make_optimizer":
        "returns an optax object; the port has no optax.  Its Adam is "
        "`training.adam_update` with `learning_rate_schedule`.",
    "ops/pallas/fc_forward.py:TILE_B": _PALLAS.format(
        "fc_forward", ", `fc_forward.plan`", "fc_forward.fc_forward"),
    "ops/pallas/fc_forward.py:fc_forward_pallas": _PALLAS.format(
        "fc_forward", ", `fc_forward.plan`", "fc_forward.fc_forward"),
    "ops/pallas/merger.py:TILE_B": _PALLAS.format(
        "merger", "", "merger.merger_forward"),
    "ops/pallas/merger_int.py:LANES": _PALLAS.format(
        "merger_int", "", "merger_int.merger_int_forward"),
    "parallel/wavefront2.py:CANP_HALO_NOOP": _KNOB.format(
        "drops the halo exchange, a timing probe whose outputs are wrong "
        "on purpose"),
    "parallel/wavefront2.py:CANP_MATMUL_GATHERS": _KNOB.format(
        "swaps the trial's scan gathers for one-hot matmuls on the TPU "
        "and changes no output; the port gathers"),
    "parallel/rate_model.py:CANP_TPU_CTX_CALIBRATION": _CAL,
    "parallel/rate_model.py:CALIBRATION_PATH": _CAL,
    "parallel/rate_model.py:states_for": _CAL,
}
# No entry for CANP_STUB_RDOQ: the JAX package names it only inside the
# docstring of wavefront2's `quantize_rd` (:661-665), so it reads it
# nowhere and the scan does not see it.


def jax_modules():
    return sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


def port_path(rel):
    return MODULE_MAP.get(rel, rel)


def parse(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def top_statements(body):
    """Module-level statements, those under `if` / `try` included."""
    for s in body:
        if isinstance(s, ast.If):
            yield from top_statements(s.body)
            yield from top_statements(s.orelse)
        elif isinstance(s, ast.Try):
            yield from top_statements(s.body)
            for h in s.handlers:
                yield from top_statements(h.body)
            yield from top_statements(s.orelse)
            yield from top_statements(s.finalbody)
        else:
            yield s


def assigned(s):
    """Names an assignment statement binds."""
    if isinstance(s, ast.Assign):
        for t in s.targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    yield n.id
    elif isinstance(s, (ast.AnnAssign, ast.AugAssign)) \
            and isinstance(s.target, ast.Name):
        yield s.target.id


DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def public_names(tree) -> set:
    """The JAX module's public surface (module docstring)."""
    out = set()
    for s in top_statements(tree.body):
        if isinstance(s, DEFS) and not s.name.startswith("_"):
            out.add(s.name)
        elif isinstance(s, ast.ClassDef) and not s.name.startswith("_"):
            out.add(s.name)
            out.update(f"{s.name}.{m.name}" for m in s.body
                       if isinstance(m, DEFS) and not m.name.startswith("_"))
        else:
            out.update(n for n in assigned(s) if UPPER.match(n))
    out.update(knobs(tree))
    return out


def knobs(tree) -> set:
    """The `CANP_*` environment variables a module names."""
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and KNOB.match(n.value)}


def bound_names(tree) -> set:
    """Every name the port module binds at top level, and Class.member
    for the members of its classes (with same-module bases)."""
    out, classes = set(), {}
    for s in top_statements(tree.body):
        if isinstance(s, DEFS + (ast.ClassDef,)):
            out.add(s.name)
            if isinstance(s, ast.ClassDef):
                classes[s.name] = s
        elif isinstance(s, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in s.names)
        else:
            out.update(assigned(s))

    def members(c, seen):
        m = set()
        for x in c.body:
            if isinstance(x, DEFS + (ast.ClassDef,)):
                m.add(x.name)
            else:
                m.update(assigned(x))
        for b in c.bases:
            if isinstance(b, ast.Name) and b.id in classes \
                    and b.id not in seen:
                m |= members(classes[b.id], seen | {b.id})
        return m

    for name, c in classes.items():
        out.update(f"{name}.{m}" for m in members(c, {name}))
    return out


def parameters(tree) -> set:
    """Every parameter name of every function of the module."""
    out = set()
    for f in ast.walk(tree):
        if isinstance(f, DEFS):
            a = f.args
            out.update(x.arg for x in a.posonlyargs + a.args + a.kwonlyargs)
    return out


def missing(rel) -> set:
    """The JAX module's public names its port module does not bind."""
    port_tree = parse(PORT / port_path(rel))
    bound = bound_names(port_tree)
    params = parameters(port_tree)
    out = set()
    for name in public_names(parse(JAX / rel)):
        knob = KNOBS.get(f"{rel}:{name}")
        if KNOB.match(name):
            if knob is None or knob not in params:
                out.add(name)
        elif name not in bound:
            out.add(name)
    return out


@pytest.mark.parametrize(
    "rel", [r for r in jax_modules() if port_path(r) is not None])
def test_module_is_ported(rel):
    assert (PORT / port_path(rel)).is_file(), \
        f"{rel} has no port module {port_path(rel)}"
    unexcused = sorted(n for n in missing(rel)
                       if f"{rel}:{n}" not in EXCLUDED)
    assert not unexcused, \
        f"port {port_path(rel)} lacks {unexcused} of JAX {rel}"


def test_excluded_entries_are_live():
    """Every entry names something its JAX module defines and the port
    lacks, with a reason; every knob mapping names a variable the JAX
    module reads."""
    for key, reason in EXCLUDED.items():
        rel, name = key.split(":", 1)
        assert isinstance(reason, str) and reason.strip(), key
        assert (JAX / rel).is_file(), f"{key}: no such JAX module"
        assert name in public_names(parse(JAX / rel)), \
            f"{key}: the JAX module does not define {name}"
        assert name in missing(rel), f"{key}: the port has it now"
    for key in KNOBS:
        rel, name = key.split(":", 1)
        assert name in knobs(parse(JAX / rel)), key
        assert key not in EXCLUDED, key


def test_every_jax_module_is_mapped():
    """The mapping's keys are JAX modules, and only `ops/pallas/__init__`
    goes without a counterpart."""
    mods = set(jax_modules())
    assert set(MODULE_MAP) <= mods
    assert [r for r in mods if port_path(r) is None] \
        == ["ops/pallas/__init__.py"]


def test_port_reads_no_canp_variable():
    """The port takes every JAX knob as an argument: no port module names
    a `CANP_*` variable."""
    found = {p.relative_to(PORT).as_posix(): sorted(knobs(parse(p)))
             for p in PORT.rglob("*.py") if "_build" not in p.parts}
    assert not {k: v for k, v in found.items() if v}


def test_scan_sees_the_surface():
    """The parser finds what it must: known names, methods and knobs of
    the JAX package, and their counterparts in the port, so that the
    per-module cases cannot pass on an empty scan."""
    total = sum(len(public_names(parse(JAX / r))) for r in jax_modules())
    assert total > 400
    names = public_names(parse(JAX / "ops/transform.py"))
    assert {"forward_transform", "QUANT_SCALES", "dct_matrix"} <= names
    assert "PnnBundle.quantize" in public_names(
        parse(JAX / "codec/nn_intra.py"))
    assert "CANP_RATE_EVOLVE" in public_names(
        parse(JAX / "parallel/wavefront2.py"))
    port_bound = bound_names(parse(PORT / "codec/nn_intra.py"))
    assert {"PnnBundle", "PnnBundle.quantize"} <= port_bound
    assert "rate_evolve" in parameters(
        parse(PORT / "parallel/wavefront2.py"))
    assert not missing("ops/transform.py")
