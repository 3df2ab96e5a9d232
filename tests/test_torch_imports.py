"""The port stands alone: no module of ``diffphore_torch`` and not
``chip_smoke.py`` imports jax, flax or the JAX package, nor networkx, pandas
or PyYAML, which the card's machine does not have (checked on the source, so
nothing is imported to find out)."""

import ast
import glob
import os

import pytest

from torch_port_helpers import REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diffphore_tpu")
#: host libraries the JAX package's featurization, CLI and baselines use and
#: the port restates (chem/graph.py, the csv module, utils/flat_yaml.py,
#: baselines.sort_order)
HOST_FORBIDDEN = ("networkx", "pandas", "yaml")
SOURCES = sorted(glob.glob(os.path.join(REPO, "diffphore_torch", "**", "*.py"), recursive=True)
                 + [os.path.join(REPO, "chip_smoke.py")])


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


#: the modules of the training slice, all under the no-JAX rule above
TRAINING_MODULES = [
    "ops/tp_aggregate.py", "data/transforms.py", "data/dataset.py", "data/loaders.py",
    "train/losses.py", "train/state.py", "utils/logging.py", "cli/train.py",
    "cli/profile_train_step.py",
    # the calibrated-sampler slice
    "ops/tp_scalar.py", "train/ccsampler.py", "sampler/sampling.py", "cli/pipeline.py",
    # the kernel profiler
    "cli/profile_kernels.py",
    # the confidence head and validation by inference
    "models/confidence.py", "train/confidence.py", "train/metrics.py", "chem/rmsd.py",
    # host featurization and the screening CLI
    "chem/graph.py", "chem/mol.py", "chem/perception.py", "chem/sdf.py", "chem/smiles.py",
    "chem/topology.py", "chem/embed.py", "chem/features.py", "chem/lipo.py",
    "chem/pharmacophore_rules.py", "data/phore.py", "data/graphs.py", "ops/fitscore.py",
    "cli/inference.py",
    # training and evaluation from raw files
    "data/phore_sampling.py", "chem/conformer_matching.py", "chem/complex_phore.py",
    "cli/evaluate.py",
    # scale-out and prefetch
    "parallel/__init__.py", "parallel/mesh.py", "parallel/workers.py",
    # the host-only modules: synthetic library, AncPhore bridge, baselines, misc
    "data/synth_library.py", "utils/ancphore_bridge.py", "utils/misc.py",
    "baselines/__init__.py", "baselines/performance_analyze.py", "baselines/prepare_data.py",
    "baselines/run_docking.py", "baselines/run_ifptarget.py", "baselines/run_phore.py",
]


def test_sources_found():
    assert len(SOURCES) > 20
    assert any(p.endswith(os.path.join("ops", "tp_fused.py")) for p in SOURCES)
    rel = {os.path.relpath(p, os.path.join(REPO, "diffphore_torch")) for p in SOURCES}
    assert set(TRAINING_MODULES) <= rel


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_modules_import_without_a_gpu(module):
    """Importing builds no kernel and needs neither nvcc nor a card."""
    import importlib

    name = "diffphore_torch." + module[:-3].replace("/", ".")
    assert importlib.import_module(name).__name__ == name


def test_kernel_sources_use_no_float_atomics():
    """Every output element is written once by one thread, so that reruns
    agree to the bit: no atomic adds in the CUDA sources."""
    for path in sorted(glob.glob(os.path.join(REPO, "diffphore_torch", "csrc", "*.cu"))):
        with open(path) as f:
            code = "\n".join(line.split("//")[0] for line in f)
        assert "atomic" not in code, path


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_networkx_pandas_or_yaml_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in HOST_FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """Without CUDA, and outside a checkout, chip_smoke.py exits non-zero
    and prints no result line."""
    import shutil
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    script = os.path.join(REPO, "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(script, lone)
    for path in (script, str(lone)):
        proc = subprocess.run([sys.executable, path], capture_output=True, text=True,
                              timeout=300, cwd=os.path.dirname(path))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
