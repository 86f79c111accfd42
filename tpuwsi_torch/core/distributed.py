"""Process topology (``tpuwsi/core/distributed.py``): one process until
distribution is ported (ROADMAP.md, Queue 1, M7)."""

from __future__ import annotations

import os


def initialize_multihost():
    """→ ``(process_index, process_count)``: ``(0, 1)``. Raises where the
    environment names more than one process (``WORLD_SIZE`` > 1)."""
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={world}: multi-process training is not ported yet "
            "(ROADMAP.md, Queue 1, M7)")
    return 0, 1
