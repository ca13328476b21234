"""Hand-written Hopper kernels, each with its plain PyTorch version:
``conv3x3`` (CUDA C++, ``csrc/conv3x3.cu``), ``fused_sgd`` and
``fused_adam`` (Triton), ``flash_attention`` (CUDA C++,
``csrc/flash_attention.cu``) and ``quantize`` (CUDA C++,
``csrc/quantize.cu``).
A CUDA tensor runs the kernel, a CPU tensor the plain version
(``_backend.use_kernel``)."""
