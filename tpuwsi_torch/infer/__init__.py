"""Slide inference: chunk type, dispatch-ahead fetch and slide aggregation."""
