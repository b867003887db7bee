"""The PyTorch/CUDA port's benchmark: one command runs one cell of BENCHMARK.json."""
