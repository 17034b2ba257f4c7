"""Seeded fault injection (the port of ``dtf_tpu.fault``): the training
and serving verbs of ``DTF_FAULT_INJECT`` —
:mod:`dtf_tpu_torch.fault.inject`. The elastic run controller is not
ported yet."""
