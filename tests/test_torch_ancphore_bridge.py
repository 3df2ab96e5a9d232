"""The port's AncPhore bridge (``diffphore_torch.utils.ancphore_bridge``)
against the JAX package's: the CLI's command line for every optional flag
(a stub binary records it), the score-file floats of the real CLI on the
examples, the None paths, the build into ``build/ancphore/`` with
``native/`` left byte for byte, and ``generate_complex_phore``'s text.

The JAX side is handed a copy of the port-built CLI (``ancphore_path``, or
its ``ensure_built`` patched), so its ``make`` never runs on ``native/``."""

import hashlib
import os
import shutil

import pytest

from diffphore_torch.utils import ancphore_bridge as tb
from diffphore_tpu.utils import ancphore_bridge as jb

from torch_port_helpers import REPO

EXAMPLES = os.path.join(REPO, "examples")
PHORE = os.path.join(EXAMPLES, "example.phore")
LIGANDS = [os.path.join(EXAMPLES, f"EX0{i}.sdf") for i in (1, 2, 3)]
NATIVE = os.path.join(REPO, "native")


def native_digest():
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(NATIVE)):
        for f in sorted(files):
            h.update(os.path.relpath(os.path.join(d, f), NATIVE).encode())
            with open(os.path.join(d, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


@pytest.fixture(scope="module")
def binary():
    """The port-built CLI (built once into build/ancphore/)."""
    before = native_digest()
    path = tb.ensure_built()
    assert path is not None and os.path.dirname(path) == os.path.join(REPO, "build", "ancphore")
    assert native_digest() == before
    return path


def test_build_lands_under_build_and_leaves_native(tmp_path, monkeypatch):
    """A fresh build: the hashed name under the build directory, reused on
    the next call, native/ byte for byte as it was; a failed compile is
    logged and gives None."""
    before = native_digest()
    monkeypatch.setattr(tb, "BUILD_DIR", str(tmp_path / "build" / "ancphore"))
    target = tb.binary_path()
    monkeypatch.setattr(tb, "ANCPHORE", target)
    assert os.path.basename(target).startswith("ancphore_") and not os.path.exists(target)
    path = tb.ensure_built(target)
    assert path == target and os.access(path, os.X_OK)
    assert os.listdir(tmp_path / "build" / "ancphore") == [os.path.basename(target)]
    mtime = os.stat(path).st_mtime_ns
    assert tb.ensure_built(target) == path and os.stat(path).st_mtime_ns == mtime
    assert native_digest() == before
    broken = tmp_path / "broken.cpp"
    broken.write_text("int main( {\n")
    monkeypatch.setattr(tb, "SOURCE", str(broken))
    monkeypatch.setattr(tb, "ANCPHORE", tb.binary_path())
    assert tb.ensure_built(tb.ANCPHORE) is None
    assert native_digest() == before


def test_binary_name_follows_the_source(tmp_path, monkeypatch):
    a, b = tmp_path / "a.cpp", tmp_path / "b.cpp"
    a.write_text("int main() { return 0; }\n")
    b.write_text("int main() { return 1; }\n")
    names = []
    for src in (a, b, a):
        monkeypatch.setattr(tb, "SOURCE", str(src))
        names.append(tb.binary_path())
    assert names[0] != names[1] and names[0] == names[2]


STUB = """#!/bin/sh
printf '%s\\n' "$@" > "{argv}"
while [ $# -gt 0 ]; do
  if [ "$1" = "--scores" ]; then
    printf 'p0\\t0.0\\tref\\t5\\t2\\t1\\t2\\t3\\t0.4\\t0\\t0.5\\t0.6\\t0\\t0.7\\t0.01\\t0.2\\t0.3\\t0.4\\t0.5\\n' > "$2"
  fi
  shift
done
"""

FLAGS = {
    "default": {},
    "exvolume": {"exVolume_cutoff": 300},
    "overlap": {"overlap_coeff": 0.5},
    "percent": {"percent_coeff": 0.25},
    "anchor": {"anchor_coeff": 0.1},
    "all_coeffs": {"exVolume_cutoff": 250.5, "overlap_coeff": 0.0, "percent_coeff": 1,
                   "anchor_coeff": 0.3},
    "fishing": {"target_fishing": True},
    "return_all": {"return_all": True, "fitness": 3},
    "fitness6": {"fitness": 6, "overlap_coeff": 0.5, "percent_coeff": 0.5},
    "unknown_fitness": {"fitness": 9},
}


@pytest.mark.parametrize("flags", list(FLAGS), ids=list(FLAGS))
def test_calc_phore_fitting_argv_matches_jax(flags, tmp_path):
    got = {}
    for side, mod in (("port", tb), ("jax", jb)):
        d = tmp_path / side
        d.mkdir()
        stub = d / "ancphore"
        stub.write_text(STUB.format(argv=d / "argv.txt"))
        stub.chmod(0o755)
        scores = mod.calc_phore_fitting("lig.sdf", "ref.phore", str(d / "out.score"),
                                        log_file=str(d / "log.txt"), overwrite=True,
                                        ancphore_path=str(stub), **FLAGS[flags])
        argv = (d / "argv.txt").read_text().replace(str(d), "<dir>")
        got[side] = (scores, argv, (d / "log.txt").read_text())
    assert got["port"] == got["jax"]
    assert got["port"][0] is not None
    # an existing score file is read, not rescored, unless overwrite
    d = tmp_path / "port"
    os.remove(d / "argv.txt")
    tb.calc_phore_fitting("lig.sdf", "ref.phore", str(d / "out.score"),
                          ancphore_path=str(d / "ancphore"))
    assert not (d / "argv.txt").exists()


@pytest.fixture(scope="module")
def score_files(binary, tmp_path_factory):
    """Each example ligand scored by the port's bridge and by the JAX
    package's (through a copy of the binary), default and custom
    coefficients."""
    tmp = tmp_path_factory.mktemp("scores")
    jax_bin = tmp / "jax_bin"
    jax_bin.mkdir()
    shutil.copy2(binary, jax_bin / "ancphore")
    out = {}
    for lig in LIGANDS:
        name = os.path.basename(lig)[:-4]
        for coeffs, kw in (("default", {}), ("custom", {"overlap_coeff": 0.5,
                                                       "percent_coeff": 0.5})):
            pair = []
            for side, mod, path in (("port", tb, binary), ("jax", jb, str(jax_bin / "ancphore"))):
                f = str(tmp / f"{side}_{name}_{coeffs}.score")
                assert mod.calc_phore_fitting(lig, PHORE, f, overwrite=True, ancphore_path=path,
                                              **kw) is not None
                pair.append(f)
            out[name, coeffs] = pair
    return out


@pytest.mark.parametrize("coeffs", ["default", "custom"])
@pytest.mark.parametrize("lig", ["EX01", "EX02", "EX03"])
def test_score_file_floats_match_jax(lig, coeffs, score_files):
    port_file, jax_file = score_files[lig, coeffs]
    with open(port_file, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    for fitness in range(1, 7):
        got = tb.parse_score_file(port_file, fitness=fitness)
        assert got == jb.parse_score_file(jax_file, fitness=fitness)
        assert got and all(isinstance(x, float) for x in got)
    assert tb.parse_score_file(port_file, return_all=True) == \
        jb.parse_score_file(jax_file, return_all=True)


def test_custom_coefficients_move_only_column_minus_6(score_files):
    default, custom = score_files["EX01", "default"][0], score_files["EX01", "custom"][0]
    for fitness in (1, 2, 3, 4, 5):
        assert tb.parse_score_file(default, fitness=fitness) == \
            tb.parse_score_file(custom, fitness=fitness)
    assert tb.parse_score_file(default, fitness=6) != tb.parse_score_file(custom, fitness=6)


NONE_CASES = ["missing_binary", "no_score_file", "bad_score_file", "timeout", "absent_file"]


@pytest.mark.parametrize("case", NONE_CASES)
def test_none_paths_match_jax(case, tmp_path):
    got = {}
    for side, mod in (("port", tb), ("jax", jb)):
        d = tmp_path / side
        d.mkdir()
        stub = d / "ancphore"
        body = {"no_score_file": "exit 0", "timeout": "sleep 5",
                "bad_score_file": "for a; do :; done; printf 'a\\tb\\n' > \"$6\""}.get(case, "")
        stub.write_text(f"#!/bin/sh\n{body}\n")
        stub.chmod(0o755)
        binary = str(d / "absent") if case == "missing_binary" else str(stub)
        if case == "absent_file":
            got[side] = mod.parse_score_file(str(d / "absent.score"))
            continue
        got[side] = mod.calc_phore_fitting("lig.sdf", "ref.phore", str(d / "out.score"),
                                           overwrite=True, ancphore_path=binary, timeout=0.5)
    assert got["port"] is None and got["jax"] is None


@pytest.fixture(scope="module")
def pocket_file(tmp_path_factory):
    from diffphore_tpu.chem.sdf import read_molecule
    from test_torch_complex_phore import write_pocket

    path = str(tmp_path_factory.mktemp("pocket") / "pocket.pdb")
    write_pocket(read_molecule(LIGANDS[0], remove_hs=True), path)
    return path


def test_generate_complex_phore_matches_jax(pocket_file, tmp_path):
    got = tb.generate_complex_phore(LIGANDS[0], pocket_file, "EX01", tmp_dir=str(tmp_path / "p"))
    want = jb.generate_complex_phore(LIGANDS[0], pocket_file, "EX01", tmp_dir=str(tmp_path / "j"))
    assert got and got == want
    for d in ("p", "j"):
        assert os.path.exists(tmp_path / d / "complex_phores" / "EX01_complex.phore")
    # an existing file is kept and read back
    assert tb.generate_complex_phore(LIGANDS[1], pocket_file, "EX01",
                                     tmp_dir=str(tmp_path / "p")) == got


def test_generate_complex_phore_failure_matches_jax(tmp_path):
    bad = str(tmp_path / "absent.sdf")
    assert tb.generate_complex_phore(bad, "x.pdb", "X", tmp_dir=str(tmp_path / "p")) == \
        jb.generate_complex_phore(bad, "x.pdb", "X", tmp_dir=str(tmp_path / "j")) == ""
