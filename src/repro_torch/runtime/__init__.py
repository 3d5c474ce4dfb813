"""Runtime pieces of the port.  Counterpart of ``repro.runtime``: the
plan-driven weight streamer (``prefetch``) and the training loop's
``fault.StragglerDetector``."""
