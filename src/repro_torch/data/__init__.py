"""Deterministic synthetic data pipeline (port of ``repro/data``)."""
from .pipeline import SyntheticLM

__all__ = ["SyntheticLM"]
