"""Parallel layers of the port (counterpart of ``dtf_tpu.parallel``)."""
