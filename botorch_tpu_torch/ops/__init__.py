"""Counterpart of `botorch_tpu.ops`."""
