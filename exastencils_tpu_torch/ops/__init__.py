"""Plain PyTorch ops and CUDA kernels (reference: exastencils_tpu/ops/)."""
