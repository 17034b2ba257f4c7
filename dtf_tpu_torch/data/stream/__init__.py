"""Data streams (the port of ``dtf_tpu.data.stream``): so far only the
serve-log record codec and manifest (:mod:`.servelog`)."""
