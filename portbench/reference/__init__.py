"""The benchmark's plain reference: SegMiF's joint pipeline and its
fusion-phase training step in plain PyTorch, float32 with TF32 off. It
imports neither JAX nor anything of the program; the benchmark hands it
the same state dict and inputs that it hands the program."""
