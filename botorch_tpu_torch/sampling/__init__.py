"""Counterpart of `botorch_tpu.sampling`."""
