"""The port's slide tables held against the JAX package's, exactly.

``tpuwsi_torch.utils.minixlsx``, ``utils.labels``, ``utils.balance``,
``io.cohorts``, ``io.levels`` and ``io.metadata`` (``load_slide_table``,
``split_table``) run on column tables where the JAX package runs pandas
frames. Each case writes its cohorts' ``slides_data_<id>.xlsx`` and
``Grids_<mag>/Grid_data.xlsx`` with cells chosen to reach pandas' rules:
blank cells in integer, string and boolean columns, fold columns that mix
integers with "test" and "val", slides missing from the grid table or
listed twice there, null ids, -1 and 0 and too few tiles, bad segmentation,
ER != PR with blanks, and cohorts whose columns differ. Every field of the
two ``SlideTable``s must be equal in value and in order (NaN equal to NaN).
"""

import dataclasses
import math
import os

import numpy as np
import pandas as pd
import pytest

from tpuwsi.io import cohorts as j_cohorts
from tpuwsi.io import levels as j_levels
from tpuwsi.io import metadata as j_metadata
from tpuwsi.utils import labels as j_labels
from tpuwsi.utils import minixlsx as j_xlsx
from tpuwsi_torch.io import cohorts as t_cohorts
from tpuwsi_torch.io import levels as t_levels
from tpuwsi_torch.io import metadata as t_metadata
from tpuwsi_torch.utils import labels as t_labels
from tpuwsi_torch.utils import minixlsx as t_xlsx

TOTAL, LEGIT = "Total tiles - 256 compatible @ X10", "Legitimate tiles - 256 compatible @ X10"


def _same(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
                and type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if t_xlsx.is_null(a) or t_xlsx.is_null(b):
        return (a is None) == (b is None) and t_xlsx.is_null(a) and t_xlsx.is_null(b)
    return bool(a == b)


def _assert_same_table(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert _same(g, w), (f.name, g, w)


# -- labels, cohorts, levels -------------------------------------------------------

@pytest.mark.parametrize("target", ["Positive", "Negative", 1, 0, 3.0, float("nan"), None,
                                    "7", "Missing Data", True, np.int64(1), np.float64(1.0),
                                    ("Positive", "Negative"), ("Positive", float("nan"))])
def test_get_label_matches_jax(target):
    multi = isinstance(target, tuple)
    assert t_labels.get_label(target, multi) == j_labels.get_label(target, multi)


@pytest.mark.parametrize("dataset", sorted(j_labels.VALID_TARGETS) + ["CARMEL3", "SHEBA4",
                                                                      "UNLISTED"])
def test_assert_dataset_target_matches_jax(dataset):
    for target in ["ER", "PR", ["ER", "PR"], "Survival_Time", "is_cancer", "MRD_day15",
                   "PDL1", "binary_live", "Onco"]:
        outcomes = []
        for mod in (j_labels, t_labels):
            try:
                mod.assert_dataset_target(dataset, target)
                outcomes.append("ok")
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1]
    assert t_labels.cohort_to_int(["TCGA", "CARMEL3", "HAEMEK1"]) == \
        j_labels.cohort_to_int(["TCGA", "CARMEL3", "HAEMEK1"])
    assert [t_labels.num_2_bool(v) for v in (0, 1, 2)] == \
        [j_labels.num_2_bool(v) for v in (0, 1, 2)]


_DATASETS = ["ABCTB_TCGA", "CARMEL", "CARMEL+BENIGN", "Carmel 9-11", "CARMEL5", "CARMEL10",
             "BENIGN2", "CAT", "TCGA", "TCGA_LUNG", "HEROHE", "ABCTB_TIF", "ABCTB_TILES",
             "PORTO_HE", "PORTO_PDL1", "ABCTB", "SHEBA", "SHEBA3", "LEUKEMIA", "AML", "ALL",
             "IC", "HIC", "TMA_HE_02_008", "TMA_HE_01_011", "HAEMEK", "NOPE"]


@pytest.mark.parametrize("dataset", _DATASETS)
def test_get_datasets_dir_dict_matches_jax(dataset, tmp_path):
    overrides = {"TCGA": str(tmp_path / "elsewhere")}
    for kw in ({"data_root": str(tmp_path)}, {"data_root": str(tmp_path), "overrides": overrides}):
        try:
            want = j_cohorts.get_datasets_dir_dict(dataset, **kw)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                t_cohorts.get_datasets_dir_dict(dataset, **kw)
            continue
        assert t_cohorts.get_datasets_dir_dict(dataset, **kw) == want
    for name in ("CARMEL3", "HER2", "HAEMEK_ONCO", "TCGA_LUNG", "TCGA"):
        assert t_cohorts.get_dataset_group(name).name == j_cohorts.get_dataset_group(name).name
        assert t_cohorts.get_dataset_batch_num(name) == j_cohorts.get_dataset_batch_num(name)


def test_registry_overrides_from_env_match_jax(tmp_path, monkeypatch):
    path = tmp_path / "registry.json"
    path.write_text('{"TCGA": "/data/tcga", "CARMEL": "/data/carmel"}')
    monkeypatch.setenv("TPUWSI_COHORT_REGISTRY", str(path))
    for dataset in ("TCGA", "CARMEL", "CAT"):
        assert t_cohorts.get_datasets_dir_dict(dataset, data_root="/r") == \
            j_cohorts.get_datasets_dir_dict(dataset, data_root="/r")
    assert t_cohorts.slides_data_file("/c", "TCGA", "_x") == j_cohorts.slides_data_file(
        "/c", "TCGA", "_x")


_LEVEL_CASES = [
    ([1.0, 4.0, 16.0], 40, 10, 256),       # exact match of level 1
    ([1.0, 4.0, 16.0], 40, 20, 256),       # residual 2 from level 0
    ([1.0, 4.0, 16.0], 40, 5, 256),        # residual 2 from level 1
    ([1.0, 4.0004, 16.0], 40, 10, 256),    # isclose within 1e-3
    ([1.0, 4.01, 16.0], 40, 10, 256),      # outside the tolerance
    ([1.0, 2.0, 4.0, 8.0], 20, 10, 224),
    ([1.0], 20, 10, 256),                  # one level: residual 2
    ([1.0], 20, 40, 256),                  # upsample branch
    ([1.0, 2.0], 10, 20, 300),             # upsample branch, odd tile
    ([1.0, 3.0, 9.0], 40, 3, 128),         # odd ratios
    ([1.0], 20, 20, 256),
    ([1.0, 4.0], 20.0, 7, 256),
]


@pytest.mark.parametrize("case", _LEVEL_CASES)
def test_get_optimal_slide_level_matches_jax(case):
    assert t_levels.get_optimal_slide_level(*case) == j_levels.get_optimal_slide_level(*case)


# -- xlsx -----------------------------------------------------------------------------

_ROWS = [
    ["a.png", 1, 1.5, "Positive", True, None, 1, None, "x"],
    ["b.png", None, 2, None, False, None, "test", None, 3],
    ["c & <d>.png", 3, None, "Negative", None, None, 2, 7.25, None],
]
_HEADER = ["file", "ints", "floats", "strs", "bools", "blank", "fold", "sparse", "mixed"]


def _frame_as_table(df):
    return {name: list(df[name]) for name in df.columns}


def test_xlsx_round_trip_port_writer_to_both_readers(tmp_path):
    path = str(tmp_path / "t.xlsx")
    t_xlsx.write_xlsx(path, {name: [r[c] for r in _ROWS] for c, name in enumerate(_HEADER)})
    got, want = t_xlsx.read_xlsx(path), j_xlsx.read_xlsx(path)
    assert list(got) == list(want.columns) == _HEADER
    assert _same(got, _frame_as_table(want))
    for name in _HEADER:  # the dtypes pandas gives, as the port's kinds
        kind = {"int64": "int", "float64": "float", "bool": "bool", "str": "str"}.get(
            str(want[name].dtype), "object")
        assert t_xlsx.column_kind(got[name]) == kind, name
        for i in range(len(_ROWS)):
            assert _same(t_xlsx.scalar(got[name], i), want[name].iloc[i])
            assert type(t_xlsx.scalar(got[name], i)) is type(want[name].iloc[i]) or \
                want[name].iloc[i] is None


def test_xlsx_round_trip_jax_writer_to_port_reader(tmp_path):
    path = str(tmp_path / "j.xlsx")
    j_xlsx.write_xlsx(path, pd.DataFrame(_ROWS, columns=_HEADER))
    assert _same(t_xlsx.read_xlsx(path), _frame_as_table(j_xlsx.read_xlsx(path)))
    back = str(tmp_path / "back.xlsx")
    t_xlsx.write_xlsx(back, t_xlsx.read_xlsx(path))
    assert j_xlsx.read_xlsx(back).equals(j_xlsx.read_xlsx(path))


def test_csv_reader_matches_pandas(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text('file,ints,floats,fold,flags,blank\n"a,1",1,1.5,1,True,\n'
                    "b,,2,test,False,\nc,3,nan,2,,\n")
    got, want = t_xlsx.read_csv(str(path)), pd.read_csv(path)
    assert list(got) == list(want.columns)
    assert _same(got, _frame_as_table(want))


def test_read_table_order_and_parquet_refusal(tmp_path):
    base = str(tmp_path / "slides_data_X")
    with pytest.raises(FileNotFoundError):
        t_xlsx.read_table(base)
    (tmp_path / "slides_data_X.parquet").write_bytes(b"PAR1")
    with pytest.raises(NotImplementedError, match="parquet"):
        t_xlsx.read_table(base)
    (tmp_path / "slides_data_X.csv").write_text("file,id\na.png,X\n")
    assert t_xlsx.read_table(base) == {"file": ["a.png"], "id": ["X"]}
    t_xlsx.write_xlsx(base + ".xlsx", {"file": ["b.png"], "id": ["X"]})
    assert t_xlsx.read_table(base) == {"file": ["b.png"], "id": ["X"]}


# -- load_slide_table ---------------------------------------------------------------

def _write_cohort(cohort_dir, cohort_id, slides: dict, grids: dict, mag=10):
    os.makedirs(os.path.join(cohort_dir, f"Grids_{mag}"), exist_ok=True)
    t_xlsx.write_xlsx(os.path.join(cohort_dir, f"slides_data_{cohort_id}.xlsx"), slides)
    t_xlsx.write_xlsx(os.path.join(cohort_dir, f"Grids_{mag}", "Grid_data.xlsx"), grids)


def _tcga_cohort(root):
    """Twelve slides of a TCGA cohort and their grid table."""
    d = t_cohorts.get_datasets_dir_dict("TCGA", data_root=str(root))["TCGA"]
    n = 12
    slides = {
        "file": [f"s{i:02d}.png" for i in range(n)],
        "id": ["TCGA"] * 5 + [None] + ["TCGA"] * 6,
        "patient barcode": ["p0", "p1", "p1", "p2", "p3", "p4", "p5", "p6", "p7", "p8", "p9",
                            "p9"],
        "ER status": ["Positive", "Negative", "Positive", None, "Negative", "Positive",
                      "Negative", "Positive", "Missing Data", "Positive", "Negative",
                      "Positive"],
        "PR status": ["Positive", "Positive", None, "Negative", "Negative", "Positive",
                      "Negative", None, "Positive", "Positive", "Negative", "Negative"],
        "Her2 status": [1, 0, None, 1, 0, 1, 0, 1, 0, 2, 1, 0],
        "test fold idx": [1, 2, 3, 1, "test", 2, 3, "val", 1, 2, 3, 1],
        "Manipulated Objective Power": [20, 40, 20, 20, 40, 20, 20, 20, 40, 20, 20, 20],
        "DX": [True, False, True, None, True, True, False, True, True, True, True, False],
        "bad segmentation": [None, None, 1, None, None, None, None, None, None, 0, None, None],
    }
    grids = {
        "file": [f"s{i:02d}.png" for i in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)] + ["s03.png"],
        TOTAL: [100, 90, 80, -1, 70, 60, 50, 40, 30, 20, 10, 100],
        LEGIT: [50, 40, 0, 30, 25, None, 5, 35, 45, 8, 12, 60],
    }
    _write_cohort(d, "TCGA", slides, grids)
    return d


@pytest.fixture(scope="module")
def tcga_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tcga")
    _tcga_cohort(root)
    return str(root)


_FLAGS = [
    dict(),
    dict(train=False),
    dict(test_fold=0),
    dict(test_fold=-1),
    dict(test_fold=-1, train=False),
    dict(train_type="MIL", bag_size=30),
    dict(train_type="Infer", infer_folds=[1, 0]),
    dict(train_type="Infer", infer_folds=[None]),
    dict(train_type="Infer_All_Folds"),
    dict(n_tiles=40),
    dict(dx=True),
    dict(er_eq_pr=True),
    dict(er_eq_pr=True, train=False),
    dict(target_kind="PR"),
    dict(target_kind="OR"),
    dict(target_kind="Her2"),
    dict(target_kind="ER+PR"),
    dict(target_kind="ER+Her2", train_type="Infer", infer_folds=[1, 2, 3]),
    dict(balanced_dataset=True, rng="seed"),
    dict(ram_saver=True, rng="seed", train_type="Infer_All_Folds"),
    dict(tile_size=256, desired_magnification=10, train_type="MIL", bag_size=0),
]


@pytest.mark.parametrize("flags", _FLAGS, ids=[str(f) for f in _FLAGS])
def test_load_slide_table_matches_jax(tcga_root, flags):
    flags = dict(flags)
    seeded = flags.pop("rng", None) == "seed"
    tables = []
    for mod in (j_metadata, t_metadata):
        kw = dict(flags, rng=np.random.default_rng(7)) if seeded else flags
        tables.append(mod.load_slide_table("TCGA", data_root=tcga_root, **kw))
    want, got = tables
    _assert_same_table(got, want)
    assert np.array_equal(got.labels(), want.labels())
    for i in range(len(want)):
        assert got.slide_path(i) == want.slide_path(i)
    split = [mod.split_table(t, 0.6, np.random.default_rng(3))
             for mod, t in ((j_metadata, want), (t_metadata, got))]
    for part in range(2):
        _assert_same_table(split[1][part], split[0][part])


def _other_cohorts(root):
    """Cohorts for the filters of other datasets: survival (ABCTB), the
    LEUKEMIA day column (ALL), slide_per_block (CARMEL1), the PORTO origin
    (PORTO_HE), and CAT's breast fold column over two cohorts whose columns
    differ (TCGA and CARMEL1)."""
    dirs = {}
    dirs["ABCTB"] = str(root / "abctb")
    _write_cohort(dirs["ABCTB"], "ABCTB", {
        "file": ["a0.png", "a1.png", "a2.png", "a3.png"], "id": ["ABCTB"] * 4,
        "patient barcode": ["q0", "q1", "q2", "q3"],
        "ER status": ["Positive", "Negative", None, "Positive"],
        "Censored": [True, False, None, True], "Time (months)": [12.5, None, 30, 7],
        "Survival Binary (5 Yr)": [1, 0, None, 1],
        "test fold idx": [1, 2, 2, 3], "Manipulated Objective Power": [20, 20, 40, 20],
    }, {"file": ["a0.png", "a1.png", "a2.png", "a3.png"], TOTAL: [50] * 4,
        LEGIT: [20, 30, 40, 50]})
    dirs["ALL"] = str(root / "all")
    _write_cohort(dirs["ALL"], "ALL", {
        "file": ["l0.png", "l1.png", "l2.png", "l3.png"], "id": ["ALL"] * 4,
        "patient barcode": ["r0", "r1", "r2", "r3"],
        "MRD_day15 status": ["Positive", "Negative", "Positive", "Negative"],
        "MRD_day33 status": ["Negative", "Negative", "Positive", "Positive"],
        "Day_0/15/33_fixed": [15, 33, None, 15],
        "test fold idx": [1, 2, 2, 2], "Manipulated Objective Power": [20] * 4,
    }, {"file": ["l0.png", "l1.png", "l2.png", "l3.png"], TOTAL: [50] * 4, LEGIT: [20] * 4})
    dirs["CARMEL1"] = str(root / "carmel1")
    _write_cohort(dirs["CARMEL1"], "CARMEL1", {
        "file": ["c0.png", "c1.png", "c2.png", "c3.png", "c4.png"], "id": ["CARMEL1"] * 5,
        "patient barcode": ["11-5_1_1_a", "11-5_1_1_b", "11-6_2_1_a", 17, "11-6_2_1_c"],
        "ER status": ["Positive", "Negative", "Positive", "Negative", "Negative"],
        "test fold idx": [1, 2, 2, 3, 2], "test fold idx breast": [1, 1, 2, 2, "val"],
        "Manipulated Objective Power": [40] * 5,
    }, {"file": ["c0.png", "c1.png", "c2.png", "c3.png", "c4.png"], TOTAL: [50] * 5,
        LEGIT: [20] * 5})
    dirs["PORTO_HE"] = str(root / "porto")
    _write_cohort(dirs["PORTO_HE"], "PORTO_HE", {
        "file": ["o0.png", "o1.png", "o2.png"], "id": ["PORTO_HE"] * 3,
        "patient barcode": ["o0", "o1", "o2"], "Origin": ["lung", "pleura", None],
        "PDL1 status": ["Positive", "Negative", "Positive"],
        "test fold idx": [1, 2, 2], "Manipulated Objective Power": [20] * 3,
    }, {"file": ["o0.png", "o1.png", "o2.png"], TOTAL: [50] * 3, LEGIT: [20] * 3})
    tcga = _tcga_cohort(root)
    # CAT's fold column, TCGA's slides without it
    dirs["TCGA"] = tcga
    return dirs


_OTHER = [
    ("ABCTB", ["ABCTB"], dict(target_kind="Survival_Time")),
    ("ABCTB", ["ABCTB"], dict(target_kind="Survival_Binary", train=False)),
    ("ABCTB", ["ABCTB"], dict(target_kind="Survival_Time", train_type="Infer_All_Folds")),
    ("ALL", ["ALL"], dict(target_kind="MRD_day15", train_type="Infer_All_Folds")),
    ("ALL", ["ALL"], dict(target_kind="MRD_day33")),
    ("CARMEL", ["CARMEL1"], dict(slide_per_block=True, train_type="Infer_All_Folds")),
    ("CARMEL", ["CARMEL1"], dict(train=False)),
    ("PORTO_HE", ["PORTO_HE"], dict(target_kind="PDL1", train_type="Infer_All_Folds")),
    ("CAT", ["TCGA", "CARMEL1"], dict(train_type="Infer_All_Folds")),
    ("CAT", ["CARMEL1", "TCGA"], dict(train=False)),
    ("CAT", ["TCGA", "CARMEL1"], dict(dx=True, train_type="Infer", infer_folds=[1, 2])),
]


@pytest.mark.parametrize("dataset,cohorts,flags", _OTHER,
                         ids=[f"{d}-{'+'.join(c)}-{f}" for d, c, f in _OTHER])
def test_load_slide_table_other_datasets_match_jax(tmp_path, dataset, cohorts, flags):
    dirs = _other_cohorts(tmp_path)
    dir_dict = {c: dirs[c] for c in cohorts}
    if dataset == "CAT":  # TCGA's slides in CAT's breast fold column
        slides = t_xlsx.read_xlsx(os.path.join(dirs["TCGA"], "slides_data_TCGA.xlsx"))
        slides["test fold idx breast"] = slides["test fold idx"]
        t_xlsx.write_xlsx(os.path.join(dirs["TCGA"], "slides_data_TCGA.xlsx"), slides)
    outcomes = []
    for mod in (j_metadata, t_metadata):
        try:
            outcomes.append(mod.load_slide_table(dataset, dir_dict=dir_dict, **flags))
        except ValueError as e:
            outcomes.append(str(e))
    want, got = outcomes
    if isinstance(want, str):
        assert got == want
        return
    _assert_same_table(got, want)
    assert np.array_equal(got.labels(), want.labels())


def test_slide_per_block_refuses_other_datasets(tmp_path):
    dirs = _other_cohorts(tmp_path)
    for mod in (j_metadata, t_metadata):
        with pytest.raises(ValueError, match="CARMEL"):
            mod.load_slide_table("ABCTB", dir_dict={"ABCTB": dirs["ABCTB"]},
                                 target_kind="ER", slide_per_block=True)


def test_balance_dataset_er_matches_jax(tcga_root):
    from tpuwsi.utils.balance import balance_dataset_er as j_balance
    from tpuwsi_torch.utils.balance import balance_dataset_er as t_balance

    path = os.path.join(tcga_root, "Breast", "TCGA", "slides_data_TCGA.xlsx")
    for seed in range(4):
        want = j_balance(j_xlsx.read_xlsx(path), np.random.default_rng(seed))
        got = t_balance(t_xlsx.read_xlsx(path), np.random.default_rng(seed))
        assert got["use_in_balanced_data_ER"] == list(want["use_in_balanced_data_ER"])
    assert math.isnan(t_xlsx.read_xlsx(path)["ER status"][3])
