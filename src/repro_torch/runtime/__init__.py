"""Runtime pieces of the port.  Counterpart of ``repro.runtime``: the
plan-driven weight streamer (``prefetch``), the continuous-batching
serving scheduler (``scheduler``) and the training loop's
``fault.StragglerDetector``."""
