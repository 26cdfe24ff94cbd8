"""Quantizer configuration for the port (slice 1: KV-page freezing)."""
from .spec import METHODS, QuantSpec, as_spec, device_methods, get_method

__all__ = ["METHODS", "QuantSpec", "as_spec", "device_methods", "get_method"]
