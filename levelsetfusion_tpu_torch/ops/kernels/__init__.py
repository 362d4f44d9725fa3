"""Hand-written CUDA kernels of the solve loop (sources in ``csrc/``), each
beside its plain torch version. The device of the input tensors decides:
CUDA tensors launch the kernel, CPU tensors take the plain version."""
