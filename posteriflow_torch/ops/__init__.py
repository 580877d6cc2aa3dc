"""The rational-quadratic spline: plain PyTorch version (`rqs`) and the
hand-written CUDA kernel behind `rqs_cuda`, which the flow calls."""
