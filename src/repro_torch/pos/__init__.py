"""A dataClay-like distributed Persistent Object Store (paper section 6).

Objects are distributed across Data Services; method execution follows the
objects (execution requests are redirected to the Data Service storing the
receiver); prefetching warms each Data Service's local memory from its own
disk, in parallel across services.
"""

from .eviction import POLICIES, EvictionPolicy, SharedBudget, make_policy  # noqa: F401
from .latency import LatencyModel  # noqa: F401
from .trace import TRACE_SCHEMA_VERSION, TraceEvent, as_events, trace_oids  # noqa: F401
from .store import ObjectStore, PersistentObject  # noqa: F401
from .client import POSClient, Session  # noqa: F401
