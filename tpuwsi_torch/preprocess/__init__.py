"""Tile preprocessing: normalisation banks and the eval recipe."""
