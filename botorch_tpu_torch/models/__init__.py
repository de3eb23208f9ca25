"""Counterpart of `botorch_tpu.models`."""
