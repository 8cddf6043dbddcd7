"""Cloud-infrastructure substrate for the WaaS simulation."""
from .cloud import VM, VMPool  # noqa: F401
