"""The plain reference the benchmark judges the program by: plain PyTorch
in float32 with TF32 off, no kernel and nothing of the measured program
(`nets`, `physics`, `train`, `precision`)."""
