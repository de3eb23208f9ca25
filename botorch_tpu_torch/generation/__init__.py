"""Counterpart of `botorch_tpu.generation`."""
