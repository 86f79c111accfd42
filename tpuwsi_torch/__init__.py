"""tpuwsi_torch: the PyTorch/CUDA port of tpuwsi for NVIDIA Hopper GPUs.

The JAX package ``tpuwsi`` is the reference that this package is held
against; nothing here imports jax or flax. The ported slice so far is tile
scoring and feature extraction with a ViT (``cli.train.extract_features``,
``cli.train.evaluate_slides``).
"""
