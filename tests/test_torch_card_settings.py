"""The card's library settings (`hosnerf_tpu_torch/utils/card.py`): every
entry point of the port calls `card.configure()` right after parsing its
arguments, before it builds a model or touches the card; `configure()`
sets and reads back TF32 off, cuDNN deterministic without its benchmark
search and a fixed cuBLAS workspace; `tools/ab_compare.py` configures an
older checkout by what that checkout has. No JAX, no model: each entry
point is stopped at `configure()`.
"""

import ast
import glob
import importlib
import importlib.util
import json
import os
import sys

import pytest
import torch

from hosnerf_tpu_torch.utils import card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "hosnerf_tpu_torch")

# each tool's main with the least arguments it parses on the CPU
TOOL_ARGS = {
    "ab_compare": ["checkout_a", "checkout_b"],
    "bench_all": ["--device", "cpu"],
    "bench_deconv": ["--device", "cpu"],
    "bench_lbs": ["--device", "cpu"],
    "bench_lbs_pg": ["--device", "cpu"],
    "bench_mlp": ["--device", "cpu"],
    "blend_bwd_f64": [],
    "convergence_probe": ["--device", "cpu"],
    "f32_route_ab": [],
    "fg_density_study": ["--device", "cpu"],
    "grad_parity": ["--device", "cpu"],
    "memcheck_8patch": ["--device", "cpu"],
    "parity_runbook": ["--datadir", "capture", "--scene", "mini",
                       "--device", "cpu"],
    "pg_density_study": ["--device", "cpu"],
    "pg_window_study": ["--device", "cpu"],
    "profile_human": ["--device", "cpu"],
    "profile_step": ["--device", "cpu"],
    "profile_tail": ["--device", "cpu"],
    "proto_pairgrid": None,      # main() reads sys.argv
    "ref_flops": ["--device", "cpu"],
    "time_step": ["--device", "cpu"],
}


class Configured(Exception):
    """Raised by the patched `card.configure()`."""


class BuiltFirst(Exception):
    """Raised where an nn.Module is built before `card.configure()`."""


@pytest.fixture
def flags(monkeypatch):
    """Restore torch's flags and the environment after a test that sets
    them for real."""
    for mod, name in ((torch.backends.cuda.matmul, "allow_tf32"),
                      (torch.backends.cudnn, "allow_tf32"),
                      (torch.backends.cudnn, "deterministic"),
                      (torch.backends.cudnn, "benchmark")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)


@pytest.fixture
def stop_at_configure(monkeypatch):
    """`card.configure()` raises Configured, and building an nn.Module
    raises BuiltFirst: an entry point stops at whichever comes first."""

    def build(self, *args, **kwargs):
        raise BuiltFirst(type(self).__name__)

    def configure():
        raise Configured

    monkeypatch.setattr(torch.nn.Module, "__init__", build)
    monkeypatch.setattr(card, "configure", configure)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _call(entry, monkeypatch, tmp_path):
    """Call one entry point with minimal CPU arguments."""
    if entry.startswith("tools."):
        name = entry.split(".", 1)[1]
        mod = importlib.import_module(f"hosnerf_tpu_torch.tools.{name}")
        if TOOL_ARGS[name] is None:
            monkeypatch.setattr(sys, "argv", [name, "--device", "cpu"])
            return mod.main()
        return mod.main(TOOL_ARGS[name])
    if entry == "cli.run":
        from hosnerf_tpu_torch.cli import run
        return run.main(["--stage", "human", "--device", "cpu",
                         "--logbase", str(tmp_path)])
    if entry == "entry.main":
        from hosnerf_tpu_torch import entry as ent
        return ent.main(["--device", "cpu"])
    if entry == "entry._worker":
        from hosnerf_tpu_torch import entry as ent
        spec = tmp_path / "spec0.json"
        spec.write_text(json.dumps({
            "rank": 0, "world": 1, "local_rank": 0, "threads": None,
            "init": "file://" + str(tmp_path / "init"), "backend": "gloo",
            "device": "cpu", "size": "tiny", "out": str(tmp_path)}))
        monkeypatch.setenv("LOCAL_RANK", "0")
        return ent._worker(str(spec))
    if entry == "train.gradcheck":
        from hosnerf_tpu_torch.train import gradcheck
        monkeypatch.setattr(sys, "argv", ["gradcheck", "--device", "cpu"])
        return gradcheck.main()
    if entry == "chip_smoke":
        cs = _chip_smoke()
        # past its no-card exit: the settings come before any card work
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        return cs.main()
    raise KeyError(entry)


ENTRIES = ([f"tools.{n}" for n in sorted(TOOL_ARGS)]
           + ["cli.run", "entry.main", "entry._worker", "train.gradcheck",
              "chip_smoke"])


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_point_configures_the_card_first(entry, stop_at_configure,
                                               monkeypatch, tmp_path):
    """The entry point reaches `card.configure()` (patched to raise)
    before it builds any nn.Module."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(Configured):
        _call(entry, monkeypatch, tmp_path)


def test_every_tool_main_has_a_case():
    """Each module under hosnerf_tpu_torch/tools/ with a top-level main
    is one case above."""
    mains = set()
    for path in glob.glob(os.path.join(PKG, "tools", "*.py")):
        tree = ast.parse(open(path).read())
        if any(isinstance(n, ast.FunctionDef) and n.name == "main"
               for n in tree.body):
            mains.add(os.path.basename(path)[:-3])
    assert mains == set(TOOL_ARGS)


def test_configure_sets_and_reads_back_every_setting(flags):
    """On the CPU configure() only sets flags; settings() reads each of
    them back from torch, with the f32 matmul precision TF32-off gives."""
    got = card.configure()
    assert got == {
        "matmul_allow_tf32": False,
        "cudnn_allow_tf32": False,
        "cudnn_deterministic": True,
        "cudnn_benchmark": False,
        "cublas_workspace_config": ":4096:8",
        "float32_matmul_precision": "highest",
    }
    assert card.settings() == got
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert torch.backends.cudnn.deterministic is True


def test_configure_keeps_a_workspace_the_environment_names(flags,
                                                           monkeypatch):
    """A CUBLAS_WORKSPACE_CONFIG already in the environment stays."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    assert card.configure()["cublas_workspace_config"] == ":16:8"


def test_ab_compare_configures_an_older_checkout(flags, monkeypatch):
    """A checkout without utils/card.py (modelled by a None entry in
    sys.modules, which makes its import fail) is configured by its
    `loop.set_reproducible()` and TF32 off; one with it by its
    `configure()`."""
    from hosnerf_tpu_torch.tools import ab_compare
    from hosnerf_tpu_torch.train import loop
    calls = []
    monkeypatch.setattr(loop, "set_reproducible",
                        lambda: calls.append("set_reproducible"),
                        raising=False)
    monkeypatch.setitem(sys.modules, "hosnerf_tpu_torch.utils.card", None)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    ab_compare.configure_checkout(torch)
    assert calls == ["set_reproducible"]
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    monkeypatch.setitem(sys.modules, "hosnerf_tpu_torch.utils.card", card)
    monkeypatch.setattr(card, "configure",
                        lambda: calls.append("configure"))
    ab_compare.configure_checkout(torch)
    assert calls == ["set_reproducible", "configure"]


SETTERS = ("allow_tf32", "deterministic", "benchmark")
# (file, function) where the settings may be assigned: the settings
# function, phase cli's return to torch's defaults, ab_compare's fallback
# for older checkouts
ALLOWED = {("hosnerf_tpu_torch/utils/card.py", "configure"),
           ("chip_smoke.py", "torch_defaults"),
           ("hosnerf_tpu_torch/tools/ab_compare.py", "configure_checkout")}


def _sets_a_setting(node) -> bool:
    """An assignment to a torch backend flag, or anything that writes
    CUBLAS_WORKSPACE_CONFIG into the environment."""
    if isinstance(node, ast.Assign):
        if any(isinstance(t, ast.Attribute) and t.attr in SETTERS
               and "backends" in ast.unparse(t) for t in node.targets):
            return True
        return "CUBLAS_WORKSPACE_CONFIG" in ast.unparse(node.targets[0])
    return (isinstance(node, ast.Call)
            and ast.unparse(node.func).endswith(("setdefault", "putenv"))
            and "CUBLAS_WORKSPACE_CONFIG" in ast.unparse(node))


def _assignments(path):
    """(innermost function, statement) of every setting written in one
    file."""
    found = []

    def visit(node, fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = node.name
        if _sets_a_setting(node):
            found.append((fn, ast.unparse(node)))
        for child in ast.iter_child_nodes(node):
            visit(child, fn)

    visit(ast.parse(open(path).read()), "<module>")
    return found


def test_only_the_settings_function_assigns_the_settings():
    """No module of the port and not chip_smoke.py assigns TF32, cuDNN's
    determinism or benchmark flags or the cuBLAS workspace outside
    ALLOWED."""
    paths = glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True)
    bad = []
    for path in paths + [os.path.join(REPO, "chip_smoke.py")]:
        rel = os.path.relpath(path, REPO)
        for fn, what in _assignments(path):
            if (rel, fn) not in ALLOWED:
                bad.append((rel, fn, what))
    assert bad == []
