"""Seeded fault injection (the port of ``dtf_tpu.fault``): the serving
family only — :mod:`dtf_tpu_torch.fault.inject`."""
