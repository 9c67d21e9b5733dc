"""The port stands alone: it imports with JAX blocked, contains no import
of the JAX package or of JAX, and its entry points default to the card
and raise without one."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "surface_sampling_tpu_torch"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import surface_sampling_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "new = {'core.ff_relax', 'parallel.tempering', 'parallel.population',"
        " 'parallel.mesh', 'parallel.training', 'models.mace', 'pourbaix', 'pourbaix.atoms',"
        " 'pourbaix.compatibility', 'pourbaix.entries', 'pourbaix.potential',"
        " 'pourbaix.utils', 'structure.io', 'utils', 'utils.sampling',"
        " 'cli.common', 'cli.default_settings', 'cli.sample_surface',"
        " 'cli.sample_pourbaix_surface', 'cli.sample_bulk', 'cli.predict', 'io',"
        " 'io.checkpoint', 'utils.logging', 'utils.misc', 'utils.plot', 'utils.setup',"
        " 'utils.tracing', 'analysis', 'analysis.statistics', 'runtime', 'runtime.native',"
        " 'analysis.clustering', 'analysis.uncertainty', 'cli.clustering', 'cli.cut_surfaces',"
        " 'cli.filter_stoichiometries', 'cli.perturb_structures',"
        " 'cli.create_surface_formation_entries', 'models.convert_nff',"
        " 'models.convert_chgnet', 'models.convert_mace'}\n"
        "assert new <= {n.split('.', 1)[1] for n in names}, names\n"
        "import chip_smoke\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib is imported at module import'\n"
        "assert 'sklearn' not in sys.modules, 'sklearn is imported at module import'\n"
        "leaked = [m for m in sys.modules if m == 'surface_sampling_tpu'"
        " or m.startswith('surface_sampling_tpu.')]\n"
        "assert not leaked, leaked\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_import_of_the_jax_package_or_jax():
    """Neither the port nor the scripts that drive it on the card (nor the
    ranks of the sharding tests) import the JAX package or JAX."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                           REPO / "tools" / "port_profile.py",
                                           REPO / "tools" / "port_compare.py",
                                           REPO / "tools" / "delta_bits.py",
                                           REPO / "tests" / "torch_sharding_ranks.py"]
    assert len(files) >= 20
    for path in files:
        for name in _imports(path):
            assert not (name == "surface_sampling_tpu"
                        or name.startswith("surface_sampling_tpu.")), (path, name)
            assert name.split(".")[0] != "jax", (path, name)


def test_entry_point_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    from surface_sampling_tpu_torch.device import resolve_device
    from surface_sampling_tpu_torch.systems import lamno3_001_chgnet, srtio3_001_painn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srtio3_001_painn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lamno3_001_chgnet()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_chip_smoke_fails_without_a_card():
    """Run with no arguments from the repository root, chip_smoke.py exits
    non-zero and prints no result when no CUDA device is visible."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _eam_entry_points():
    from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
    from surface_sampling_tpu_torch.ops.eam_kernels import make_eam_kernel_potential
    from surface_sampling_tpu_torch.potentials import eam
    from surface_sampling_tpu_torch.systems import au110_eam, cu100_eam

    spec = cu100_eam(device="cpu").spec
    tables = eam.builtin_eam("Cu_u3")
    nbr = build_static_neighbor_table(spec, tables.cutoff, relax_slack=0.05)
    return {
        "cu100_eam": lambda: cu100_eam(),
        "cu100_eam_fast": lambda: cu100_eam(fast=True),
        "au110_eam": lambda: au110_eam(),
        "make_eam": lambda: eam.make_eam(tables),
        "make_eam_static": lambda: eam.make_eam_static(tables, nbr, mode="cheb"),
        "make_eam_rigid": lambda: eam.make_eam_rigid(tables, spec),
        "make_eam_kernel_potential": lambda: make_eam_kernel_potential(tables, nbr),
    }


@pytest.mark.parametrize("name", ["cu100_eam", "cu100_eam_fast", "au110_eam", "make_eam",
                                  "make_eam_static", "make_eam_rigid",
                                  "make_eam_kernel_potential"])
def test_eam_entry_points_default_to_cuda(monkeypatch, name):
    """The EAM systems, potentials and the kernel potential default to the
    card and raise without one."""
    build = _eam_entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


def test_training_modules_import_and_finetune_defaults_to_cuda(monkeypatch, tmp_path):
    """The training slice's modules are part of the port's import walk, and
    the fine-tuning CLI runs on the card unless ``--device cpu`` is given:
    without a card it raises before any work."""
    import importlib

    for name in ("models.train", "models.dataset", "models.prediction", "cli.finetune"):
        importlib.import_module(f"surface_sampling_tpu_torch.{name}")
    from surface_sampling_tpu_torch.cli import finetune

    (tmp_path / "d.json").write_text("[]")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune.main(["--data", str(tmp_path / "d.json"), "--out", str(tmp_path / "o")])


@pytest.mark.parametrize("cli", ["clustering", "perturb_structures",
                                 "create_surface_formation_entries"])
def test_model_clis_default_to_cuda(monkeypatch, tmp_path, cli):
    """The three structure-tool CLIs that evaluate a model run on the card
    unless ``--device cpu`` is given: without a card they raise before any
    work."""
    import importlib
    import json

    from surface_sampling_tpu_torch.structure import bulk
    from surface_sampling_tpu_torch.structure.io import write_cif

    write_cif(tmp_path / "s.cif", bulk("Cu", "fcc", 3.6147))
    (tmp_path / "c.json").write_text(json.dumps({"calc_settings": {"calc_name": "lj"}}))
    common = ["--structures", str(tmp_path / "s.cif"), "--settings", str(tmp_path / "c.json")]
    argv = {"clustering": common + ["--out", str(tmp_path / "o")],
            "perturb_structures": common + ["--out", str(tmp_path / "o")],
            "create_surface_formation_entries": common + [
                "--phase-diagram", str(REPO / "tests/data/pourbaix/pd_dict.json"),
                "--out", str(tmp_path / "o.json")]}[cli]
    main = importlib.import_module(f"surface_sampling_tpu_torch.cli.{cli}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not (tmp_path / "o").exists() and not (tmp_path / "o.json").exists()
