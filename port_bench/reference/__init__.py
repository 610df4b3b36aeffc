"""The plain reference the benchmark holds the port to: plain PyTorch in
float32 with TF32 off, importing nothing of the port or of JAX."""
