"""Tensor ops: catalogs, tempering, resampling and the MH-sweep kernel."""
