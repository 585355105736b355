"""The fused check: its CUDA kernel, the kernel's PyTorch twin and the checker."""
