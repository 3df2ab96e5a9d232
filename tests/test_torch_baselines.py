"""The port's baseline drivers (``diffphore_torch.baselines``) against the JAX
package's on the same files: every JSON and CSV they write equal but for
``run_time`` (and the output directory inside a path), the rows in pandas'
order, ties and NaN included, and the skip paths of missing binaries.

AncPhore scoring runs the CLI the port builds into ``build/ancphore/``; the
JAX side gets a copy of it through its patched ``ensure_built``, so its
``make`` never runs on ``native/``."""

import csv
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest

from diffphore_torch import baselines as tbase
from diffphore_torch.baselines import performance_analyze as tperf
from diffphore_torch.baselines import prepare_data as tprep
from diffphore_torch.baselines import run_docking as tdock
from diffphore_torch.baselines import run_ifptarget as tifp
from diffphore_torch.baselines import run_phore as tphore
from diffphore_torch.utils import ancphore_bridge as tbridge
from diffphore_tpu.baselines import performance_analyze as jperf
from diffphore_tpu.baselines import prepare_data as jprep
from diffphore_tpu.baselines import run_docking as jdock
from diffphore_tpu.baselines import run_ifptarget as jifp
from diffphore_tpu.baselines import run_phore as jphore
from diffphore_tpu.utils import ancphore_bridge as jbridge

from torch_port_helpers import REPO

EXAMPLES = os.path.join(REPO, "examples")
PHORE = os.path.join(EXAMPLES, "example.phore")
LIGANDS = [os.path.join(EXAMPLES, f"EX0{i}.sdf") for i in (1, 2, 3)]


@pytest.fixture(scope="module")
def binary():
    path = tbridge.ensure_built()
    assert path is not None
    return path


@pytest.fixture
def jax_cli(binary, tmp_path, monkeypatch):
    """The JAX bridge runs a copy of the port-built CLI."""
    d = tmp_path / "jax_bin"
    d.mkdir()
    copy = str(d / "ancphore")
    shutil.copy2(binary, copy)
    monkeypatch.setattr(jbridge, "ensure_built", lambda path=None: copy)
    return copy


def without_run_time(obj, out_dir):
    if isinstance(obj, dict):
        return {k: without_run_time(v, out_dir) for k, v in obj.items() if k != "run_time"}
    if isinstance(obj, list):
        return [without_run_time(v, out_dir) for v in obj]
    if isinstance(obj, str):
        return obj.replace(str(out_dir), "<out>")
    return obj


def read_json(path, out_dir):
    with open(path) as f:
        return without_run_time(json.load(f), out_dir)


def read_table(path):
    """A written CSV without its run_time column, cells as text."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return rows
    keep = [i for i, c in enumerate(rows[0]) if c != "run_time"]
    return [[r[i] for i in keep] for r in rows]


def run_both(tmp_path, port_main, jax_main, argv):
    """Each package's main() on the same arguments, each into its own out_dir."""
    out = {}
    for side, fn in (("port", port_main), ("jax", jax_main)):
        d = tmp_path / side
        fn(argv + ["--out_dir", str(d)])
        out[side] = d
    return out["port"], out["jax"]


def write_csv(path, rows):
    pd.DataFrame(rows).to_csv(path, index=False)
    return str(path)


# ---------------------------------------------------------------- ordering


@pytest.mark.parametrize("n", [0, 1, 5, 16, 17, 40, 300])
@pytest.mark.parametrize("ascending", [True, False], ids=["ascending", "descending"])
def test_sort_order_matches_pandas(n, ascending):
    """Ties and NaN: few distinct values, so most rows tie."""
    rng = np.random.default_rng(n)
    values = rng.integers(0, 4, n).astype(float) / 4
    values[rng.random(n) < 0.15] = np.nan
    df = pd.DataFrame({"best_score": values, "row": np.arange(n)})
    want = list(df.sort_values("best_score", ascending=ascending)["row"])
    assert tbase.sort_order(values, ascending) == want


def test_write_frame_matches_pandas(tmp_path):
    rows = [{"name": "a,b", "best_score": 0.1, "run_time": 1e-05, "label": 1},
            {"name": 'q"x', "best_score": float("nan"), "run_time": 12345678901234567.0,
             "label": 0}]
    tbase.write_frame(str(tmp_path / "port.csv"), rows)
    pd.DataFrame(rows).to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()
    tbase.write_frame(str(tmp_path / "empty.csv"), [])
    pd.DataFrame([]).to_csv(tmp_path / "empty_pd.csv", index=False)
    assert (tmp_path / "empty.csv").read_bytes() == (tmp_path / "empty_pd.csv").read_bytes()


# ---------------------------------------------------------------- run_phore


def test_run_phore_align_matches_jax(tmp_path, jax_cli):
    csv_path = write_csv(tmp_path / "tasks.csv", [
        {"ligand_description": LIGANDS[0], "phore": PHORE},
        {"ligand_description": LIGANDS[1], "phore": PHORE},
        {"ligand_description": "CC(=O)Nc1ccc(O)cc1", "phore": ""},   # a random phore
        {"ligand_description": "C1CC(", "phore": PHORE},             # unparsable: skipped
    ])
    port, jax = run_both(tmp_path, tphore.main, jphore.main,
                         ["--task", "align", "--dataset_csv", csv_path, "--seed", "3"])
    got = read_json(port / "ancphore_results.json", port)
    assert got == read_json(jax / "ancphore_results.json", jax)
    assert [r["name"] for r in got] == ["EX01", "EX02", "CC(=O)Nc1ccc(O)cc1"]
    for sub in ("conformers", "sample_phores", "scores"):
        for f in sorted(os.listdir(jax / sub)):
            assert (port / sub / f).read_bytes() == (jax / sub / f).read_bytes(), f


def test_run_phore_screen_matches_jax(tmp_path, jax_cli):
    rows = [{"ligand_description": p, "label": int(i == 0)} for i, p in enumerate(LIGANDS)]
    csv_path = write_csv(tmp_path / "screen.csv", rows)
    port, jax = run_both(tmp_path, tphore.main, jphore.main,
                         ["--task", "screen", "--dataset_csv", csv_path, "--phore", PHORE])
    assert read_json(port / "ancphore_screen_summary.json", port) == \
        read_json(jax / "ancphore_screen_summary.json", jax)
    table = read_table(port / "ancphore_screen_ranked.csv")
    assert table == read_table(jax / "ancphore_screen_ranked.csv")
    scores = [float(r[1]) for r in table[1:]]
    assert table[0] == ["name", "best_score", "label"] and len(scores) == 3
    assert scores == sorted(scores, reverse=True)


def test_run_phore_screen_ties_in_pandas_order(tmp_path, jax_cli):
    """One SDF under several names ties on its score: the rows stand in the
    order pandas' sort gives them."""
    names = []
    for name, src in (("A", LIGANDS[0]), ("B", LIGANDS[1]), ("C", LIGANDS[0]),
                      ("D", LIGANDS[2]), ("E", LIGANDS[0])):
        dst = tmp_path / f"{name}.sdf"
        shutil.copy(src, dst)
        names.append({"ligand_description": str(dst)})
    csv_path = write_csv(tmp_path / "ties.csv", names)
    port, jax = run_both(tmp_path, tphore.main, jphore.main,
                         ["--task", "screen", "--dataset_csv", csv_path, "--phore", PHORE])
    table = read_table(port / "ancphore_screen_ranked.csv")
    assert table == read_table(jax / "ancphore_screen_ranked.csv")
    # the same rows in their insertion order, sorted by pandas itself
    by_name = {r[0]: r for r in table[1:]}
    unsorted = pd.DataFrame([{"name": n, "best_score": float(by_name[n][1])} for n in "ABCDE"])
    assert [r[0] for r in table[1:]] == \
        list(unsorted.sort_values("best_score", ascending=False)["name"])
    assert len({by_name[n][1] for n in "ACE"}) == 1


def test_run_phore_fishing_matches_jax(tmp_path, jax_cli):
    phores = tmp_path / "phores"
    phores.mkdir()
    for t in ("targetA", "targetB"):
        shutil.copy(PHORE, phores / f"{t}.phore")
    port, jax = run_both(tmp_path, tphore.main, jphore.main,
                         ["--task", "fishing", "--ligand", LIGANDS[0],
                          "--phore_dir", str(phores)])
    table = read_table(port / "ancphore_fishing_ranked.csv")
    assert table == read_table(jax / "ancphore_fishing_ranked.csv")
    # a tie, in the order pandas' sort gives the rows as they were found
    found = pd.DataFrame([{"target": t, "best_score": float(table[1][1])}
                          for t in ("targetA", "targetB")])
    assert table[1][1] == table[2][1]
    assert [r[0] for r in table[1:]] == \
        list(found.sort_values("best_score", ascending=False)["target"])


EXITS = {
    "align": ["--task", "align"],
    "screen": ["--task", "screen", "--dataset_csv", "x.csv"],
    "fishing_ligand": ["--task", "fishing"],
    "fishing_dir": ["--task", "fishing", "--ligand", "CCO", "--phore_dir", "absent_dir"],
}


@pytest.mark.parametrize("case", list(EXITS), ids=list(EXITS))
def test_run_phore_system_exits_match_jax(case, tmp_path):
    msgs = []
    for side, fn in (("port", tphore.main), ("jax", jphore.main)):
        with pytest.raises(SystemExit) as e:
            fn(EXITS[case] + ["--out_dir", str(tmp_path / side)])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[0]


def test_run_phore_missing_aligner_skips(tmp_path):
    csv_path = write_csv(tmp_path / "tasks.csv", [{"ligand_description": LIGANDS[0],
                                                    "phore": PHORE}])
    port, jax = run_both(tmp_path, tphore.main, jphore.main,
                         ["--dataset_csv", csv_path, "--tool", "pharao",
                          "--binary", "pharao_not_installed"])
    assert read_json(port / "pharao_results.json", port) == \
        read_json(jax / "pharao_results.json", jax) == []


def test_split_sdf_and_random_phore_match_jax(tmp_path):
    multi = tmp_path / "multi.sdf"
    multi.write_text("".join(open(p).read() for p in LIGANDS))
    got = tphore.split_sdf_file(str(multi), str(tmp_path / "p"))
    want = jphore.split_sdf_file(str(multi), str(tmp_path / "j"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        assert open(a).read() == open(b).read()
    a = tphore.generate_random_phore(got[0], str(tmp_path / "pp"), seed=5)
    b = jphore.generate_random_phore(want[0], str(tmp_path / "jp"), seed=5)
    assert open(a).read() == open(b).read()


# ---------------------------------------------------------------- performance_analyze


RECORDS = {"c1": [0.5, 3.0, 1.5, 6.0, 0.9, 2.2], "c2": [4.0, 1.2, 7.5],
           "c3": [2.0] * 12, "c4": [5.0, 0.99, 1.01, 10.0, 1.99, 2.01, 0.1]}


@pytest.mark.parametrize("topk", [(1, 5, 10), (1, 3), (2,)])
def test_performance_table_matches_jax(topk):
    assert tperf.performance_table(RECORDS, topk) == jperf.performance_table(RECORDS, topk)
    assert tperf.performance_table({}) == jperf.performance_table({}) == {"n_complexes": 0}


def test_performance_analyze_main_matches_jax(tmp_path):
    from diffphore_torch.chem.sdf import parse_sdf, write_sdf

    poses = tmp_path / "poses"
    poses.mkdir()
    rng = np.random.default_rng(0)
    for p in LIGANDS[:2]:
        mol = parse_sdf(p)[0].remove_hs()
        name = os.path.basename(p)[:-4]
        sets = [mol.coords + rng.normal(scale=s, size=mol.coords.shape) for s in (0.0, 0.4, 1.5)]
        write_sdf(mol, str(poses / f"{name}_ranked.sdf"), multi_coords=sets, name=name,
                  marker="rank")
    shutil.copy(LIGANDS[0], poses / "nomatch_ranked.sdf")          # no ground truth
    for side, fn in (("port", tperf.main), ("jax", jperf.main)):
        fn(["--poses_dir", str(poses), "--truth_dir", EXAMPLES,
            "--out", str(tmp_path / f"{side}.json")])
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert tperf.collect_all_records(str(poses), EXAMPLES) == \
        jperf.collect_all_records(str(poses), EXAMPLES)
    assert json.loads((tmp_path / "port.json").read_text())["n_complexes"] == 2


# ---------------------------------------------------------------- prepare_data


def test_prepare_vs_dataset_same_bytes(tmp_path):
    ligs = tmp_path / "ligs"
    ligs.mkdir()
    for name in ("b.sdf", "a.mol2", "c.smi", "skip.txt", "d,e.sdf"):
        (ligs / name).write_text("x\n")
    for side, mod in (("port", tprep), ("jax", jprep)):
        mod.main(["vs", "--ligand_dir", str(ligs), "--phore", PHORE,
                  "--out_csv", str(tmp_path / f"{side}.csv")])
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert len((tmp_path / "port.csv").read_text().splitlines()) == 5


def test_prepare_receptors_skip_without_adfr(tmp_path):
    pdbs = tmp_path / "pdbs"
    pdbs.mkdir()
    (pdbs / "r.pdb").write_text("END\n")
    got = tprep.prepare_datasets(str(pdbs), str(tmp_path / "p"))
    assert got == jprep.prepare_datasets(str(pdbs), str(tmp_path / "j")) == []
    assert tprep.process_pdb("r.pdb", "r.pdbqt", "prepare_receptor_not_installed") is None


# ---------------------------------------------------------------- run_docking

VINA_STUB = """#!/bin/sh
lig=""; out=""
while [ $# -gt 0 ]; do
  case "$1" in --ligand) lig="$2";; --receptor) rec="$2";; --out) out="$2";; esac
  shift
done
case "$(basename "$lig")$(basename "$rec")" in
  *l1*) a="-7.5";; *l2*) a="-9.25";; *l3*) a="-7.5";; *r2*) a="-6.0";; *) a="-8.0";;
esac
printf 'MODEL 1\\nREMARK VINA RESULT:    %s      0.000      0.000\\nREMARK VINA RESULT:    -5.1      1.2      2.0\\n' "$a" > "$out"
"""


@pytest.fixture
def vina(tmp_path):
    path = tmp_path / "vina_stub"
    path.write_text(VINA_STUB)
    path.chmod(0o755)
    return str(path)


def test_run_docking_matches_jax(tmp_path, vina):
    rows = [{"name": f"l{i}", "receptor": "r.pdbqt", "ligand": f"l{i}.pdbqt",
             "cx": 1.5 * i, "cy": 0, "cz": -2} for i in (1, 2, 3)]
    rows.append({"name": "", "receptor": "r.pdbqt", "ligand": "x/l4.pdbqt", "cx": 0,
                 "cy": 0, "cz": 0})
    csv_path = write_csv(tmp_path / "dock.csv", rows)
    port, jax = run_both(tmp_path, tdock.main, jdock.main,
                         ["--task", "docking", "--binary", vina, "--dataset_csv", csv_path])
    got = read_json(port / "docking_results.json", port)
    assert got == read_json(jax / "docking_results.json", jax)
    assert [r["best"] for r in got] == [-7.5, -9.25, -7.5, -8.0]
    assert got[3]["name"] == "nan"        # an empty name cell reads as NaN, as in pandas


def test_run_docking_virtual_screening_matches_jax(tmp_path, vina):
    rows = [{"ligand": f"l{i}.pdbqt", "label": int(i == 2)} for i in (1, 2, 3, 4)]
    csv_path = write_csv(tmp_path / "vs.csv", rows)
    receptor = tmp_path / "rec.pdbqt"
    receptor.write_text("x\n")
    port, jax = run_both(tmp_path, tdock.main, jdock.main,
                         ["--task", "virtual_screening", "--binary", vina, "--dataset_csv",
                          csv_path, "--receptor", str(receptor), "--cx", "1", "--cy", "2"])
    assert read_json(port / "vs_summary.json", port) == read_json(jax / "vs_summary.json", jax)
    table = read_table(port / "vs_ranked.csv")
    assert table == read_table(jax / "vs_ranked.csv")
    assert [r[0] for r in table[1:]] == ["l2", "l4", "l1", "l3"]


def test_run_docking_target_fishing_matches_jax(tmp_path, vina):
    rows = [{"receptor": f"r{i}.pdbqt", "cx": 0, "cy": 0, "cz": 0} for i in (1, 2, 3)]
    csv_path = write_csv(tmp_path / "fish.csv", rows)
    ligand = tmp_path / "query.pdbqt"
    ligand.write_text("x\n")
    port, jax = run_both(tmp_path, tdock.main, jdock.main,
                         ["--task", "target_fishing", "--binary", vina, "--dataset_csv",
                          csv_path, "--ligand", str(ligand)])
    table = read_table(port / "fishing_ranked.csv")
    assert table == read_table(jax / "fishing_ranked.csv")
    assert [r[0] for r in table[1:]] == ["r1", "r3", "r2"]      # r1 and r3 tie at -8.0


def test_parse_vina_scores_matches_jax(tmp_path):
    out = tmp_path / "out.pdbqt"
    out.write_text("REMARK VINA RESULT: -7.1 0 0\nREMARK VINA RESULT: bad\n"
                   "REMARK VINA RESULT:\nATOM\nREMARK VINA RESULT: -6 1 2\n")
    assert tdock.parse_vina_scores(str(out)) == jdock.parse_vina_scores(str(out)) == [-7.1, -6.0]
    assert tdock.parse_vina_scores(str(tmp_path / "none")) == []


def test_run_docking_missing_vina_skips(tmp_path):
    csv_path = write_csv(tmp_path / "dock.csv", [{"receptor": "r.pdbqt", "ligand": "l.pdbqt",
                                                  "cx": 0, "cy": 0, "cz": 0}])
    argv = ["--binary", "vina_not_installed", "--dataset_csv", csv_path]
    port, jax = run_both(tmp_path, tdock.main, jdock.main, ["--task", "docking"] + argv)
    assert read_json(port / "docking_results.json", port) == \
        read_json(jax / "docking_results.json", jax) == []


def test_run_docking_screen_without_results_writes_an_empty_table(tmp_path):
    """No docked ligand: the JAX package's ``sort_values`` on an empty frame
    raises KeyError; the port writes pandas' empty table and n = 0."""
    csv_path = write_csv(tmp_path / "vs.csv", [{"ligand": "l1.pdbqt", "label": 1}])
    receptor = tmp_path / "rec.pdbqt"
    receptor.write_text("x\n")
    argv = ["--task", "virtual_screening", "--binary", "vina_not_installed",
            "--dataset_csv", csv_path, "--receptor", str(receptor)]
    with pytest.raises(KeyError):
        jdock.main(argv + ["--out_dir", str(tmp_path / "jax")])
    tdock.main(argv + ["--out_dir", str(tmp_path / "port")])
    assert (tmp_path / "port" / "vs_ranked.csv").read_text() == "\n"
    assert read_json(tmp_path / "port" / "vs_summary.json", tmp_path / "port") == \
        {"n": 0, "ranked_csv": "<out>/vs_ranked.csv"}


# ---------------------------------------------------------------- run_ifptarget


@pytest.mark.parametrize("n,shards", [(0, 4), (1, 4), (7, 3), (8, 4), (9, 4), (10, 1), (3, 8)])
def test_split_index_matches_jax(n, shards):
    assert tifp.split_index(n, shards) == jifp.split_index(n, shards)
    assert [i for r in tifp.split_index(n, shards) for i in r] == list(range(n))


def test_run_ifptarget_missing_binary_skips(tmp_path):
    ligs = tmp_path / "ligs"
    ligs.mkdir()
    for p in LIGANDS:
        shutil.copy(p, ligs)
    out = {}
    for side, fn in (("port", tifp.main), ("jax", jifp.main)):
        d = tmp_path / side
        d.mkdir()        # the JAX driver writes its summary into an existing directory
        fn(["--ligand_dir", str(ligs), "--binary", "IFPTarget_not_installed",
            "--out_dir", str(d)])
        out[side] = (d / "summary.json").read_text()
    assert out["port"] == out["jax"] == '{"shards": []}'
    tifp.main(["--ligand_dir", str(ligs), "--binary", "IFPTarget_not_installed",
               "--out_dir", str(tmp_path / "fresh")])
    assert (tmp_path / "fresh" / "summary.json").read_text() == '{"shards": []}'


def test_run_ifptarget_runs_shards_like_jax(tmp_path):
    ligs = tmp_path / "ligs"
    ligs.mkdir()
    for p in LIGANDS:
        shutil.copy(p, ligs)
    stub = tmp_path / "ifp_stub"
    stub.write_text('#!/bin/sh\ncp "$2" "$4"\n')
    stub.chmod(0o755)
    out = {}
    for side, fn in (("port", tifp.main), ("jax", jifp.main)):
        d = tmp_path / side
        d.mkdir()
        fn(["--ligand_dir", str(ligs), "--binary", str(stub), "--shards", "2",
            "--out_dir", str(d)])
        out[side] = (read_json(d / "summary.json", d),
                     sorted((f, (d / f).read_text()) for f in os.listdir(d)
                            if f != "summary.json"))
    assert out["port"] == out["jax"]
    assert len(out["port"][0]["shards"]) == 2
