"""PyTorch + CUDA port of mistralrs_tpu, for NVIDIA Hopper (H100).

The package mirrors mistralrs_tpu's module paths (quant/, ops/, models/,
pipeline/, engine/, utils/) so each module's counterpart is easy to find. It
imports torch and never jax or mistralrs_tpu. Hand-written CUDA kernels live
under csrc/ and are built with nvcc on first use (ops/kernels.py). Entry
points run on "cuda" unless the caller passes device="cpu"; on the CPU every
kernel wrapper takes its plain PyTorch version.
"""
