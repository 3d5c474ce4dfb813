"""Runtime pieces of the training loop.  Counterpart of ``repro.runtime``;
so far only ``fault.StragglerDetector``."""
