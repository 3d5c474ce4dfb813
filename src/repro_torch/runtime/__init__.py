"""Runtime pieces of the port.  Counterpart of ``repro.runtime``: the
plan-driven weight streamer (``prefetch``), the continuous-batching
serving scheduler (``scheduler``), the training loop's
``fault.StragglerDetector`` and the object store's
``fault.StoreFaultDetector``."""
