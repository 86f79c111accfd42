"""tpuwsi_torch: the PyTorch/CUDA port of tpuwsi for NVIDIA Hopper GPUs.

The JAX package ``tpuwsi`` is the reference that this package is held
against; nothing here imports jax or flax. Ported so far: tile scoring and
feature extraction with a ViT (``cli.train.extract_features``,
``cli.train.evaluate_slides``) and DINO self-supervised training over a
folder of image tiles (``python -m tpuwsi_torch.cli.train --ssl``).
"""
