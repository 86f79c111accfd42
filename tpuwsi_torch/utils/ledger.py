"""Experiment ledger (``tpuwsi/utils/ledger.py``).

An append-only ``run_data.jsonl`` under the runs directory (atomic appends,
last record wins per experiment) with one ``Exp_<n>-<stem>-TestFold_<k>``
directory per experiment, the same records as the reference writes. The
reference's ``export_xlsx`` needs pandas; it raises here until the slide
tables are ported (ROADMAP.md, M1).
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Dict, List, Optional

LEDGER_FIELDS_DEFAULTS = {
    "Test Fold": 1,
    "Transformations": "none",
    "Tile Size": 256,
    "Tiles Per Bag": 50,
    "MultiSlide Per Bag": False,
    "No. of Bags": 1,
    "DX": False,
    "DataSet": "TCGA",
    "Test Set (DataSet)": None,
    "Receptor": None,
    "Model": "None",
    "Last Epoch": 0,
    "Transformation String": "None",
    "Desired Slide Magnification": 10,
    "Per Patient Training": False,
    "Last Layer Freeze": False,
    "Repeating Data": False,
    "Data Limit": None,
    "Free Bias": False,
    "Carmel Only": False,
    "Using Feature from CAT model alone": False,
    "Remark": "",
    "Class Relation": None,
    "Learning Rate": -1,
    "Weight Decay": -1,
    "Censor Ratio": -1,
    "Combined Loss Weights": [],
    "Receptor + is_Tumor Train Mode": -1,
    "Trained with Domain Adaptation": False,
}


class ExperimentLedger:
    def __init__(self, runs_dir: str = "runs"):
        self.runs_dir = os.path.abspath(runs_dir)
        os.makedirs(self.runs_dir, exist_ok=True)
        self.path = os.path.join(self.runs_dir, "run_data.jsonl")

    def _append(self, record: Dict):
        line = json.dumps(record, default=str)
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    def _records(self) -> List[Dict]:
        if not os.path.isfile(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def _state(self) -> Dict[int, Dict]:
        state: Dict[int, Dict] = {}
        for rec in self._records():
            state.setdefault(int(rec["Experiment"]), {}).update(rec)
        return state

    def create(self, receptor: str, test_fold=1, name=None, subname=None, **fields) -> Dict:
        """A new numbered experiment and its directory. ``name``
        (--experiment) replaces the target as the folder stem; ``subname``
        (--subexperiment) nests a folder under it."""
        state = self._state()
        stem = name or receptor
        # the id is claimed by an atomic mkdir, so two jobs started together
        # cannot take the same one
        experiment = max(state) + 1 if state else 1
        claims = os.path.join(self.runs_dir, ".exp_claims")
        os.makedirs(claims, exist_ok=True)
        while True:
            try:
                os.makedirs(os.path.join(claims, str(experiment)), exist_ok=False)
                break
            except FileExistsError:
                experiment += 1
        location = os.path.join(self.runs_dir, f"Exp_{experiment}-{stem}-TestFold_{test_fold}")
        if subname:
            location = os.path.join(location, subname)
        record = dict(LEDGER_FIELDS_DEFAULTS)
        record.update({
            "Experiment": experiment,
            "Start Date": str(datetime.date.today()),
            "Test Fold": test_fold,
            "Receptor": receptor,
            "Location": location,
        })
        record.update(fields)
        os.makedirs(location, exist_ok=True)
        self._append(record)
        return {"Location": location, "Experiment": experiment}

    def update(self, experiment: int, **fields):
        if int(experiment) not in self._state():
            raise KeyError(f"unknown experiment {experiment}")
        self._append({"Experiment": int(experiment), **fields})

    def resume(self, experiment: int) -> Dict:
        state = self._state()
        if int(experiment) not in state:
            raise KeyError(f"unknown experiment {experiment}")
        return state[int(experiment)]

    def all_experiments(self) -> Dict[int, Dict]:
        return self._state()

    def export_xlsx(self, path: Optional[str] = None) -> str:
        raise NotImplementedError(
            "export_xlsx writes through pandas, which this package does not use; the xlsx "
            "writer comes with the slide tables (ROADMAP.md, Queue 1, M1). The records are "
            f"in {self.path}")
