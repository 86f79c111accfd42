"""ViT model, JAX-parameter converter and name registry."""
