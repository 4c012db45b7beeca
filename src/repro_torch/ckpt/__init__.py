"""Checkpointing of the training path."""
