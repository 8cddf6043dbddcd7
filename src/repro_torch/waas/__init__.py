"""WaaS-for-ML bridge: EBPSM scheduling multi-tenant ML jobs on the
slice catalogue."""
from .platform import (compare_policies, run_platform, straggler_experiment,  # noqa: F401
                       sweep)
from .mljobs import ml_workload  # noqa: F401
