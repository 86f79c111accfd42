"""Patient-level dataset balancing (``tpuwsi/utils/balance.py``), on a column
table (``utils.minixlsx``).

Parity: utils.py:605-665 ``balance_dataset`` — ER branch: keep all Negative
patients, sample an equal number of Positive patients (patient = unique
'patient barcode'; per-patient status = first occurrence), with the JAX
package's draws from the same generator.
"""

from __future__ import annotations

import numpy as np

from tpuwsi_torch.utils.minixlsx import Table


def balance_dataset_er(meta: Table, rng: np.random.Generator | None = None) -> Table:
    """A copy of ``meta`` with 'use_in_balanced_data_ER' ∈ {0,1} added
    (utils.py:643-663)."""
    rng = rng or np.random.default_rng(2021)
    status_col = meta["ER status"]
    use = [1 if s == "Negative" else 0 for s in status_col]

    barcodes = np.asarray([str(b) for b in meta["patient barcode"]])
    _, first_idx, inverse = np.unique(barcodes, return_index=True, return_inverse=True)
    status = np.asarray([status_col[i] for i in first_idx])
    n_negative = int(np.sum(status == "Negative"))
    positive_patients = np.where(status == "Positive")[0]
    take = rng.choice(positive_patients, size=min(n_negative, len(positive_patients)),
                      replace=False)
    for p in take:
        for i in np.flatnonzero(inverse == p):
            use[i] = 1
    return {**meta, "use_in_balanced_data_ER": use}
