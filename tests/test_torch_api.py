"""The port's public API against the JAX package's: every subpackage's
``__all__`` carries JAX's names, through the table below of names the port
gives another name or has no object for; ``__version__``; the package's
TF32 policy set before anything else; and the port's own imports: no
module of ``hsimae_tpu_torch``, nor ``chip_smoke.py`` or
``examples/quickstart_torch.py``, imports JAX, flax, optax, sklearn,
matplotlib or ``hsimae_tpu``, and importing every subpackage loads none of
them."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SUBPACKAGES = ["", "models", "train", "data", "checkpoints", "utils", "ops", "parallel",
               "serving", "bench", "models.baselines"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sklearn", "matplotlib", "hsimae_tpu")
# (subpackage, JAX name) -> the port's name, where it names the object differently
RENAMED = {
    ("train", "adamw"): "AdamW",  # optax's transform factory; the port's is a torch optimizer
    ("checkpoints", "OrbaxCheckpointer"): "AsyncCheckpointer",  # torch.save on a thread, no orbax
    ("checkpoints", "export_torch_state_dict"): "from_jax_params",  # flax tree -> state dict
    ("parallel", "shard_params_tp"): "shard_model_tp",  # splits a module's layers in place
    ("serving", "export_flax_classifier"): "export_module_classifier",  # any torch module
}
# (subpackage, JAX name) -> why the port has no such object
ABSENT = {
    ("models", "init_model"): "flax builds a parameter tree from a key; the port's build_* "
                              "functions return initialised modules (seed=...)",
    ("checkpoints", "convert_torch_state_dict"): "reference torch names are the port's own: a "
                                                 "reference state dict loads as it is",
    ("utils", "PRNG"): "a jax.random key splitter; torch draws come from seeded generators",
    ("ops", "FUSED_BLOCK_AVAILABLE"): "no availability flag, by design: on a CUDA tensor the "
                                      "wrapper launches its kernel or raises",
    ("parallel", "batch_sharding"): "a JAX NamedSharding; the port's ranks take rows "
                                    "(process_local_slice, shard_batch)",
    ("parallel", "replicated"): "a JAX NamedSharding; the port's replicate broadcasts modules",
}


def module_name(pkg: str, root: str) -> str:
    return f"{root}.{pkg}" if pkg else root


@pytest.mark.parametrize("pkg", SUBPACKAGES)
def test_all_carries_jax_names(pkg):
    jax_mod = importlib.import_module(module_name(pkg, "hsimae_tpu"))
    port = importlib.import_module(module_name(pkg, "hsimae_tpu_torch"))
    want = [RENAMED.get((pkg, n), n) for n in jax_mod.__all__ if (pkg, n) not in ABSENT]
    assert set(want) <= set(port.__all__), sorted(set(want) - set(port.__all__))
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    for (p, n) in list(RENAMED) + list(ABSENT):
        if p == pkg:
            assert n in jax_mod.__all__ and n not in port.__all__, n


def test_version_is_jax_version():
    import hsimae_tpu
    import hsimae_tpu_torch
    from hsimae_tpu_torch.version import __version__

    assert hsimae_tpu_torch.__version__ == __version__ == hsimae_tpu.__version__ == "0.1.0"


def test_tf32_policy_comes_first():
    """``hsimae_tpu_torch/__init__.py`` sets the TF32 policy before it
    imports anything of the package."""
    body = ast.parse((REPO / "hsimae_tpu_torch" / "__init__.py").read_text()).body
    stmts = [s for s in body if not (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant))]
    assert ast.unparse(stmts[0]) == "import torch"
    assert [ast.unparse(s) for s in stmts[1:3]] == [
        "torch.backends.cuda.matmul.allow_tf32 = False",
        "torch.backends.cudnn.allow_tf32 = False"]


def imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_forbidden_import_in_the_source():
    files = sorted((REPO / "hsimae_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "examples" / "quickstart_torch.py"]
    bad = {str(f.relative_to(REPO)): sorted(set(imported_roots(f)) & set(FORBIDDEN))
           for f in files}
    assert len(files) > 40 and not {f: b for f, b in bad.items() if b}


IMPORT_ALL = """
import importlib, json, pkgutil, sys
import hsimae_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hsimae_tpu_torch.__path__, "hsimae_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted({m.split(".")[0] for m in sys.modules} & set(json.loads(sys.argv[1])))
print(json.dumps({"modules": len(names), "forbidden": loaded,
                  "tf32": [torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32]}))
"""
OPS_ONLY = """
import json, sys
import hsimae_tpu_torch.ops, hsimae_tpu_torch.serving
print(json.dumps(sorted(m for m in sys.modules if m.startswith("hsimae_tpu_torch.models"))))
"""


def run_python(code, *args):
    r = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout.strip().splitlines()[-1]


def test_importing_every_module_loads_no_forbidden_package():
    import json

    out = json.loads(run_python("import torch\n" + IMPORT_ALL, json.dumps(FORBIDDEN)))
    assert out["modules"] > 40 and out["forbidden"] == [] and out["tf32"] == [False, False]


def test_ops_and_serving_import_no_model_source():
    import json

    assert json.loads(run_python(OPS_ONLY)) == []
