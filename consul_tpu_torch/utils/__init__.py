"""Host-side helpers: device choice and the CUDA kernel builder."""
