"""Counterpart of `botorch_tpu.posteriors`."""
