"""The port's device: a CUDA card, or the CPU only where a caller names it."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """Return ``torch.device("cuda")``, or raise when no CUDA device exists.

    Also turns TF32 off for fp32 matrix products and cuDNN convolutions
    (``torch.backends.cuda.matmul.allow_tf32 = False``,
    ``torch.backends.cudnn.allow_tf32 = False``), so fp32 work keeps full
    fp32 precision as in the JAX reference. Runs on the CPU happen only where
    the caller passes ``torch.device("cpu")`` explicitly.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: tpuwsi_torch runs on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
