"""Run logging and code/args snapshots (``tpuwsi/utils/runlog.py``).

``start_log``: a stream handler and, with ``to_file``, ``<output_dir>/log.txt``,
then the full argument dump; ``save_code_files``: the sources and the
argument namespace into ``<output_dir>/Code``; ``update_summary``: one row
per epoch of ``summary.csv`` (timm's ``update_summary``).
"""

from __future__ import annotations

import csv
import glob
import json
import logging
import os
from shutil import copyfile
from typing import Dict, Optional


def start_log(args, to_file: bool = False, output_dir: Optional[str] = None):
    handlers = [logging.StreamHandler()]
    if to_file:
        output_dir = output_dir or getattr(args, "output_dir", "runs")
        os.makedirs(output_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(output_dir, "log.txt")))
    logging.basicConfig(format="%(message)s", level=logging.INFO, handlers=handlers,
                        force=True)
    logging.info("*** START ARGS ***")
    for k, v in sorted(vars(args).items() if hasattr(args, "__dict__") else
                       dict(args).items()):
        logging.info("%s: %s", k, v)
    logging.info("*** END ARGS ***")


def save_code_files(output_dir: str, args=None, code_glob: str = "tpuwsi_torch/**/*.py"):
    """Snapshot source files and args into ``<output_dir>/Code``."""
    code_dir = os.path.join(output_dir, "Code")
    os.makedirs(code_dir, exist_ok=True)
    if args is not None:
        args_dict = vars(args) if hasattr(args, "__dict__") else dict(args)
        with open(os.path.join(code_dir, "run_arguments.json"), "w") as f:
            json.dump(args_dict, f, indent=2, default=str)
    for path in glob.glob(code_glob, recursive=True) + glob.glob("*.py"):
        dst = os.path.join(code_dir, path.replace(os.sep, "__"))
        try:
            copyfile(path, dst)
        except OSError:
            pass


def update_summary(epoch: int, train_metrics: Dict, eval_metrics: Dict, filename: str,
                   write_header: bool = False):
    """One row per epoch in summary.csv: ``epoch``, ``train_<k>``, ``eval_<k>``."""
    row = {"epoch": epoch}
    row.update({f"train_{k}": v for k, v in train_metrics.items()})
    row.update({f"eval_{k}": v for k, v in eval_metrics.items()})
    exists = os.path.isfile(filename)
    with open(filename, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row))
        if write_header or not exists:
            w.writeheader()
        w.writerow(row)
