"""Counterpart of `botorch_tpu.utils`."""
