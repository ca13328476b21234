"""Hand-written Hopper kernels, each with its plain PyTorch version:
``conv3x3`` (CUDA C++, ``csrc/conv3x3.cu``), ``fused_sgd`` (Triton) and
``flash_attention`` (CUDA C++, ``csrc/flash_attention.cu``).
A CUDA tensor runs the kernel, a CPU tensor the plain version
(``_backend.use_kernel``)."""
