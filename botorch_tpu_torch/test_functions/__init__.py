"""Counterpart of `botorch_tpu.test_functions`."""
