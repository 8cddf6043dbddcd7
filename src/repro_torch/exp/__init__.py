"""Paper-grid evaluation subsystem: scenario registry, metrics collection,
and the reproduction harness
(``python -m repro_torch.exp.run --grid <name>``)."""
