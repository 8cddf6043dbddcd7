"""Hand-written Hopper kernels, one directory per kernel: ``ref.py`` (plain
torch version), ``kernel.py`` (build + launch) and ``ops.py`` (dispatch on
the tensors' device)."""
