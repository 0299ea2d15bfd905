"""Tensor ops: linear algebra, binning, histograms and the CUDA kernel."""
