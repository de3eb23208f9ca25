"""Counterpart of `botorch_tpu.acquisition`."""
