"""Open-stream multi-tenant workload subsystem.

Trace importers (Pegasus DAX XML, WfCommons JSON), arrival processes
(Poisson / Markov-modulated / diurnal / trace replay), and the tenant/QoS
model that composes many tenants into one merged workflow stream for both
engines.  See README § Workloads & tenants.
"""
from .arrivals import (ArrivalProcess, Diurnal, MarkovModulated,  # noqa: F401
                       Poisson, TraceReplay)
from .model import (BRONZE, GOLD, SILVER, QoSClass, Tenant,  # noqa: F401
                    TenantMix, TenantWorkload, assign_budgets_uniform,
                    ideal_makespan_ms)
from .traces import (bundled_trace, bundled_trace_names,  # noqa: F401
                     infer_family, load_dax, load_trace, load_wfcommons)
