"""Plain float32 reference of what the timed paths produce (plain PyTorch and NumPy; imports nothing of the program)."""
