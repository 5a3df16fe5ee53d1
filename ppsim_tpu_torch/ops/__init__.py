"""Slab-grid operations: plain PyTorch (:mod:`.grid_ops`, :mod:`.binning`)
and the Hopper kernel wrappers (:mod:`.cuda_grid`, :mod:`.cuda_rebin`)."""
