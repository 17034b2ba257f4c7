"""Host-side telemetry (the port of ``dtf_tpu.telemetry``):

- :mod:`.spans` — ``SpanRecorder``, named wall-time samples (the router's
  tick profile, the scheduler's engine-call spans);
- :mod:`.trace` — ``TraceCollector``, per-request chrome-trace events;
- :mod:`.events` — ``EventLog`` and ``read_events``, the run's durable
  event log;
- :mod:`.flight` — ``FlightRecorder``, postmortem dumps and the heartbeat
  file;
- :mod:`.run` — ``Telemetry`` (spans, tracer, flight recorder) and
  ``merge_artifact``;
- :mod:`.profile` — ``export_chrome_trace`` of the request events.

The training launchers' ``--telemetry`` (the stall watchdog, goodput,
the compile fence, device profiles) is not ported yet."""
