"""Host-side telemetry (the port of ``dtf_tpu.telemetry``): so far only
:class:`dtf_tpu_torch.telemetry.spans.SpanRecorder`, the router's
control-plane tick profile."""
