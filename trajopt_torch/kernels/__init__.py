"""Build and load the hand-written CUDA kernels (sources in ``trajopt_torch/csrc``)."""
