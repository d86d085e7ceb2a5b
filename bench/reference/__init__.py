"""Plain PyTorch references the benchmark judges the program by: float32,
TF32 off, importing nothing of the program."""
