"""Run logging and the experiment ledger (``tpuwsi/utils/runlog.py``, ``ledger.py``)."""

from tpuwsi_torch.utils.ledger import ExperimentLedger
from tpuwsi_torch.utils.runlog import save_code_files, start_log, update_summary

__all__ = ["ExperimentLedger", "save_code_files", "start_log", "update_summary"]
