"""Counterpart of `botorch_tpu.optim`."""
