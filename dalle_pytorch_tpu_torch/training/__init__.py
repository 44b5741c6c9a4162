"""Checkpoint reading and model construction from checkpoint metadata."""
