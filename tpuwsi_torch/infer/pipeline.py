"""Dispatch-ahead fetching for the serving loops (``tpuwsi/infer/pipeline.py``).

PyTorch queues device work on the current stream and returns at once. For
each chunk the loop queues the forward, then the device→host copies of its
outputs (``non_blocking``, into pinned buffers) and a ``torch.cuda.Event``
behind them. The consumer waits on a chunk's event only ``depth`` chunks
later, so the card computes chunk i while the host prepares chunk i+1 and
reads chunk i-depth. At most ``depth`` chunks' outputs are in flight.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Iterable, Iterator, Tuple

import torch


def _start_fetch(out):
    """Queue the copy of a tensor, or a tuple of tensors, to the host."""
    tensors = out if isinstance(out, tuple) else (out,)
    if all(t.device.type == "cpu" for t in tensors):
        return out, None
    host = tuple(
        torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
        for t in tensors
    )
    event = torch.cuda.Event()
    event.record()
    return (host if isinstance(out, tuple) else host[0]), event


def _finish_fetch(pending):
    out, event = pending
    if event is not None:
        event.synchronize()
    if isinstance(out, tuple):
        return tuple(t.numpy() for t in out)
    return out.numpy()


def pipelined_fetch(
    dispatches: Iterable[Tuple[Any, Any]], depth: int = 2
) -> Iterator[Tuple[Any, Any]]:
    """Consume ``(meta, device_output)`` pairs, yielding ``(meta, host_output)``
    with the wait lagging ``depth`` dispatches. Order is preserved;
    ``depth <= 0`` waits for each chunk in turn."""
    q: deque = deque()
    for meta, out in dispatches:
        q.append((meta, _start_fetch(out)))
        if len(q) > max(depth, 0):
            m, pending = q.popleft()
            yield m, _finish_fetch(pending)
    while q:
        m, pending = q.popleft()
        yield m, _finish_fetch(pending)


def eval_stream(
    chunks: Iterable[Any], images_of, single_call, depth: int = 2
) -> Iterator[Tuple[Any, Any]]:
    """Per-chunk ``(chunk, host_outputs)``: one ``single_call(images_of(chunk))``
    per chunk, fetch-pipelined ``depth`` chunks deep. Chunks may differ in
    shape."""
    return pipelined_fetch(
        ((c, single_call(images_of(c))) for c in chunks), depth=depth)
