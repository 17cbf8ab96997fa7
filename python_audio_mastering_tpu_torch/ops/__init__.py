"""Signal ops: filter design, blocked IIR, loudness and the CUDA kernels."""
