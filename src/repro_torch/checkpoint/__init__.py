"""Checkpointing: save/restore of the training state (port of
``repro/checkpoint``)."""
