"""Synthetic scientific-workflow DAG generators and workload models."""
from .dax import APP_GENERATORS, generate_workflow  # noqa: F401
from .workload import generate_workload, WorkloadSpec  # noqa: F401
